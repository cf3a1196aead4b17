"""Synthetic Pascal VOC2012 segmentation (python/paddle/dataset/voc2012.py
interface: train/test/val).  Yields (chw float32 image [3,H,W],
int64 label map [H,W] with 21 classes)."""

import numpy as np

CLASSES = 21
H = W = 64
TRAIN_SIZE = 256
TEST_SIZE = 64
VAL_SIZE = 64


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            # blocky class regions: image intensity encodes the class, so a
            # per-pixel classifier can learn the mapping
            label = np.zeros((H, W), "int64")
            img = np.zeros((3, H, W), "float32")
            for _k in range(4):
                c = int(rng.randint(0, CLASSES))
                y0, x0 = rng.randint(0, H // 2), rng.randint(0, W // 2)
                hh, ww = rng.randint(8, H // 2), rng.randint(8, W // 2)
                label[y0:y0 + hh, x0:x0 + ww] = c
                img[:, y0:y0 + hh, x0:x0 + ww] = c / float(CLASSES)
            img += 0.05 * rng.randn(3, H, W).astype("float32")
            yield np.clip(img, 0, 1).astype("float32"), label

    return reader


def train():
    return _reader(TRAIN_SIZE, 41)


def test():
    return _reader(TEST_SIZE, 42)


def val():
    return _reader(VAL_SIZE, 43)


def fetch():
    pass
