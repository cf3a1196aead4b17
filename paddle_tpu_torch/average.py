"""WeightedAverage accumulator: the port's own copy of
``paddle_tpu/average.py`` (Fluid's python/paddle/fluid/average.py)."""

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number_or_matrix_(var):
    return isinstance(var, (int, float, complex, np.ndarray)) or (
        hasattr(var, "__array__"))


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix_(value):
            raise ValueError("add() expects a number or numpy array")
        if not isinstance(weight, (int, float)):
            raise ValueError("weight must be a number")
        if self.numerator is None:
            self.numerator = np.asarray(value, "float64") * weight
            self.denominator = float(weight)
        else:
            self.numerator = self.numerator + np.asarray(value,
                                                         "float64") * weight
            self.denominator += float(weight)

    def eval(self):
        if self.numerator is None or self.denominator == 0:
            raise ValueError("eval() before add(), or zero total weight")
        return self.numerator / self.denominator
