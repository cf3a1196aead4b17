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
* ``FLAGS_tensor_array_max_len`` (default 256, as in the reference):
  the capacity of a bounded tensor array, the form a list array takes
  when a data-dependent ``while`` carries it or a data-dependent index
  writes it (``ops/control_flow.py``).
* ``FLAGS_static_check`` (default "warn", as in the reference): the
  static verifier (``core/analysis.py``) the Executor runs on a plan
  miss; ``off`` skips it, ``warn`` warns and counts
  ``static_check_warnings``, ``error`` raises ProgramVerificationError
  on an error-severity finding, before any op runs.
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
* Decode serving, the reference's defaults: ``FLAGS_speculative_k`` (0,
  off): with a bundled draft decoder, ``DecodeEngine`` proposes k tokens
  a lane through the draft's own paged pool and verifies all k + 1
  positions in one target step; ``FLAGS_kv_cache_dtype`` ("f32"): the
  KV pools' residency, ``f32`` or ``int8`` (per-(block, position, head)
  max-abs scales, ``serving/kv_cache.py``).
* Live session migration (``serving/migrate.py``), the reference's
  defaults: ``FLAGS_session_migration`` (True): the decode engine
  publishes each completed history block (prompt ++ emitted tokens)
  into its prefix index, and the server takes ``kind=session``
  ``__kvxfer__`` frames and ``__resume__`` requests;
  ``FLAGS_migrate_on_drain`` (False): a ``__retire__`` drain pushes live
  sessions to peers instead of waiting them out;
  ``FLAGS_migrate_on_pressure`` (False): a preempted sequence is pushed
  to the least-loaded peer; ``FLAGS_migrate_ack_timeout`` (10.0 s): how
  long a source waits for the destination's ``__resumeack__``.
* The serving engines' own settings, the reference's defaults, read by
  ``ServingEngine`` and ``DecodeEngine`` where a constructor argument is
  None (an argument always wins): ``FLAGS_serving_buckets`` ("1,4,16,64",
  the encoder engine's batch buckets, each warmed before traffic),
  ``FLAGS_serving_max_queue`` (256: the admission queue's cap; beyond it
  a request is shed with a retry-after, or, with tiers, evicts a queued
  request of lower weight), ``FLAGS_serving_batch_window_ms`` (2.0: how
  long the batcher waits to fill the next larger bucket),
  ``FLAGS_serving_tier_weights`` ("paid:1.0,free:0.45,batch:0.15": a
  tier's weight scales its deadline budget and orders batch assembly and
  queue-full eviction, so under overload the lowest weight sheds first;
  no tier weighs 1.0, an unknown tier the lowest configured weight),
  ``FLAGS_serving_decode_buckets`` ("4,8": the decode lanes' buckets, one
  warmed step each), ``FLAGS_serving_decode_mode`` ("token": continuous
  batching at token granularity; "request": the static-batching
  baseline), ``FLAGS_kv_block_size`` (16 tokens a KV block),
  ``FLAGS_kv_cache_blocks`` (0: the KV pool's blocks a model; 0 sizes it
  from ``FLAGS_hbm_budget_bytes``, else 64), ``FLAGS_hbm_budget_bytes``
  (0, no gate: on the card, a budget in device bytes that caps the KV
  pool at what fits beside the model's weights, and refuses a pool of
  fewer than 2 blocks; ``serving/kv_cache.py`` ``plan_num_blocks``),
  ``FLAGS_prefix_cache`` (True: admission reuses the sealed blocks of an
  identical prompt prefix) and ``FLAGS_decode_prefill_token_budget`` (0,
  unlimited: the prefill tokens one decode iteration mixes in; decode
  lanes always run).

Each flag starts from the environment variable of its name when set.
"""

import os

__all__ = ["set_flags", "get_flags", "flag"]

_DEFAULTS = {
    "FLAGS_fused_small_attention": False,
    "FLAGS_use_pallas_conv_block": False,
    "FLAGS_use_pallas_embedding_bag": False,
    "FLAGS_layout_match_params": True,
    "FLAGS_tensor_array_max_len": 256,
    "FLAGS_static_check": "warn",
    "FLAGS_serving_deadline_ms": 2000.0,
    "FLAGS_serving_endpoints_file": "",
    "FLAGS_serving_client_shed_retries": 2,
    "FLAGS_telemetry": False,
    "FLAGS_telemetry_dir": "",
    "FLAGS_telemetry_max_bytes": 256 << 20,
    "FLAGS_telemetry_series_cap": 1024,
    "FLAGS_tracing": False,
    "FLAGS_fault_spec": "",
    "FLAGS_speculative_k": 0,
    "FLAGS_kv_cache_dtype": "f32",
    "FLAGS_session_migration": True,
    "FLAGS_migrate_on_drain": False,
    "FLAGS_migrate_on_pressure": False,
    "FLAGS_migrate_ack_timeout": 10.0,
    "FLAGS_serving_buckets": "1,4,16,64",
    "FLAGS_serving_max_queue": 256,
    "FLAGS_serving_batch_window_ms": 2.0,
    "FLAGS_serving_tier_weights": "paid:1.0,free:0.45,batch:0.15",
    "FLAGS_serving_decode_buckets": "4,8",
    "FLAGS_serving_decode_mode": "token",
    "FLAGS_kv_block_size": 16,
    "FLAGS_kv_cache_blocks": 0,
    "FLAGS_hbm_budget_bytes": 0,
    "FLAGS_prefix_cache": True,
    "FLAGS_decode_prefill_token_budget": 0,
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
