"""Process-wide flags of the port.

Counterpart of ``paddle_tpu/flags.py`` (``set_flags:407``,
``get_flags:419``), holding only the flags the port reads:

* ``FLAGS_fused_small_attention`` (default False, as in the reference):
  the ``flash_attention`` op with attention-prob dropout takes the
  small-sequence kernels (``kernels/flash_attention.py``
  ``small_attention_fwd`` / ``small_attention_bwd``) where
  ``small_attention_shapes_ok`` holds, instead of the composed emission
  with a saved keep mask.  The reference keeps it off because it measured
  slower in a BERT step on its TPU.
* ``FLAGS_use_pallas_conv_block`` (default False, as in the reference):
  the ``conv2d_bn_relu`` op takes the conv-block kernels
  (``kernels/conv_block.py``: the folded-BN inference kernel, or the
  training pair of conv with channel statistics and affine + relu) where
  ``conv_block_ok`` holds, instead of the exact conv2d + batch-norm
  composition.  The reference also gates its kernel on a measured
  speed-up; the port takes the kernel wherever the flag and the shapes
  allow.
* ``FLAGS_use_pallas_embedding_bag`` (default False, as in the
  reference): the ``embedding_bag`` op takes the embedding-bag kernel
  (``kernels/embedding_bag.py``) where ``bag_checks`` holds, instead of
  the masked gather + sum composition; as for the conv block, no
  measured speed-up gates it.
* ``FLAGS_layout_match_params`` (default True, as in the reference): a
  program under the bf16 AMP policy (``contrib.mixed_precision``) keeps
  a bf16 copy of each weight whose only readers are one product
  (``mul`` / ``matmul`` / ``conv2d``), its grad and its optimizer
  (``core.lowering.analyze_param_carry``), cached across steps and
  refreshed from the new f32 master after each step; the products read
  the copy and the optimizer the master.  The copy is bitwise the
  per-step cast, so the flag moves no value.
* ``FLAGS_serving_deadline_ms`` (default 2000.0),
  ``FLAGS_serving_endpoints_file`` (default "", none) and
  ``FLAGS_serving_client_shed_retries`` (default 2), the reference's: a
  ``ServingClient``'s request deadline, the endpoints file it re-reads on
  failure, and how many shed replies it retries after their
  ``retry_after_ms`` (``serving/client.py``).

* Telemetry (``core/telemetry.py``), the reference's defaults:
  ``FLAGS_telemetry`` (off), ``FLAGS_telemetry_dir`` ("", in memory only),
  ``FLAGS_telemetry_max_bytes`` (256 MiB before ``steps.jsonl`` rotates)
  and ``FLAGS_telemetry_series_cap`` (1024 ring samples).
* The serving fleet (``serving/fleet.py``, ``rollout.py``,
  ``fleetmon.py``), the reference's defaults: the heartbeat interval and
  eviction timeout (``FLAGS_serving_hb_interval`` 0.3 s,
  ``FLAGS_serving_hb_timeout`` 2.0 s), the autoscaler's poll, streaks,
  cooldown, pressure depth and replica clamp, the canary fraction and the
  rollout gate (p99 ratio, error rate, minimum samples), the fleet
  monitor's interval and rate window, and the SLO burn-rate rules with
  their fast and slow windows, threshold and clear ratio.
  ``FLAGS_worker_hb_timeout`` (60 s) is ``HeartBeatMonitor``'s default.
* Tracing and fault injection, the reference's defaults:
  ``FLAGS_tracing`` (off; ``core/tracing.py``: spans, the
  ``trace-<pid>.jsonl`` stream and the flight recorder under
  ``FLAGS_telemetry_dir``) and ``FLAGS_fault_spec`` ("", disarmed;
  ``utils/fault_injection.py``: ``point:kind:prob[:count[:skip]];...``
  checked at the named fault points).

Each flag starts from the environment variable of its name when set.
"""

import os

__all__ = ["set_flags", "get_flags", "flag"]

_DEFAULTS = {
    "FLAGS_fused_small_attention": False,
    "FLAGS_use_pallas_conv_block": False,
    "FLAGS_use_pallas_embedding_bag": False,
    "FLAGS_layout_match_params": True,
    "FLAGS_serving_deadline_ms": 2000.0,
    "FLAGS_serving_endpoints_file": "",
    "FLAGS_serving_client_shed_retries": 2,
    "FLAGS_telemetry": False,
    "FLAGS_telemetry_dir": "",
    "FLAGS_telemetry_max_bytes": 256 << 20,
    "FLAGS_telemetry_series_cap": 1024,
    "FLAGS_tracing": False,
    "FLAGS_fault_spec": "",
    "FLAGS_worker_hb_timeout": 60.0,
    "FLAGS_serving_hb_interval": 0.3,
    "FLAGS_serving_hb_timeout": 2.0,
    "FLAGS_serving_autoscale_interval": 0.5,
    "FLAGS_serving_scale_up_ticks": 3,
    "FLAGS_serving_scale_down_ticks": 8,
    "FLAGS_serving_autoscale_cooldown": 6,
    "FLAGS_serving_scale_up_depth": 4.0,
    "FLAGS_serving_min_replicas": 1,
    "FLAGS_serving_max_replicas": 4,
    "FLAGS_serving_canary_fraction": 0.25,
    "FLAGS_rollout_gate_p99_ratio": 2.0,
    "FLAGS_rollout_gate_error_rate": 0.05,
    "FLAGS_rollout_gate_min_samples": 20,
    "FLAGS_serving_fleetmon_interval": 1.0,
    "FLAGS_serving_rate_window": 30.0,
    "FLAGS_serving_slo_rules":
        "paid_server:server_ms{tier=paid}:p99:500;decode_itl:itl_ms:p99:250",
    "FLAGS_serving_slo_fast_window": 60.0,
    "FLAGS_serving_slo_slow_window": 900.0,
    "FLAGS_serving_slo_burn_threshold": 1.0,
    "FLAGS_serving_slo_clear_ratio": 0.5,
}


def _coerce(default, value):
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return bool(value)
    return type(default)(value)


def _norm(name):
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


_flags = {k: _coerce(d, os.environ[k]) if k in os.environ else d
          for k, d in _DEFAULTS.items()}


def set_flags(flags):
    """``set_flags({"FLAGS_fused_small_attention": True})``; an unknown
    name raises, as the reference's registry does."""
    for k, v in flags.items():
        k = _norm(k)
        if k not in _DEFAULTS:
            raise ValueError("unknown flag %r (the port has: %s)"
                             % (k, ", ".join(sorted(_DEFAULTS))))
        _flags[k] = _coerce(_DEFAULTS[k], v)


def get_flags(names):
    """{name: value} of a flag name or a list of names."""
    if isinstance(names, str):
        names = [names]
    return {_norm(n): _flags.get(_norm(n)) for n in names}


def flag(name):
    return _flags.get(_norm(name))
