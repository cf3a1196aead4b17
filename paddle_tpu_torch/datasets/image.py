"""Image preprocessing helpers (python/paddle/dataset/image.py interface)
implemented on numpy only (the reference shells out to cv2; zero-egress
environment has no cv2, and these ops are trivial in numpy).  Images are
HWC uint8/float arrays unless noted."""

import numpy as np

__all__ = [
    "load_image_bytes", "load_image", "resize_short", "to_chw",
    "center_crop", "random_crop", "left_right_flip", "simple_transform",
    "load_and_transform",
]


def load_image_bytes(bytes_data, is_color=True):
    """Decode a raw .npy byte payload (the synthetic stand-in for imdecode)."""
    import io

    arr = np.load(io.BytesIO(bytes_data), allow_pickle=False)
    return arr if is_color else arr.mean(axis=2)


def load_image(file, is_color=True):
    arr = np.load(file, allow_pickle=False)
    return arr if is_color else arr.mean(axis=2)


def _resize(im, h, w):
    """Nearest-neighbor resize (numpy index sampling)."""
    sh = (np.arange(h) * im.shape[0] / float(h)).astype(int)
    sw = (np.arange(w) * im.shape[1] / float(w)).astype(int)
    return im[sh][:, sw]


def resize_short(im, size):
    h, w = im.shape[:2]
    if h < w:
        return _resize(im, size, int(round(w * size / float(h))))
    return _resize(im, int(round(h * size / float(w))), size)


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0 = max((h - size) // 2, 0)
    w0 = max((w - size) // 2, 0)
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0 = np.random.randint(0, max(h - size, 0) + 1)
    w0 = np.random.randint(0, max(w - size, 0) + 1)
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1] if im.ndim == 2 else im[:, ::-1, :]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color)
    if len(im.shape) == 3:
        im = to_chw(im)
    im = im.astype("float32")
    if mean is not None:
        mean = np.array(mean, dtype=np.float32)
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, np.newaxis, np.newaxis]
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)
