"""Image transforms (numpy/PIL), composed from ordered config keys.

Covers the reference's transform registry and composition
(``dataset/transform/transforms.py:12-60``): transforms are registered by
name and composed in the order the config lists them. Operates on uint8/float
NHWC numpy batches. Includes the custom AugMix/AugExpand-style training
augmentations in simplified numpy form.

A copy of ``quantize_tpu/data/transforms.py`` with one change: PIL is
imported by the transforms that use it, when they are built, so the
package imports, and a config without those transforms runs, where
Pillow is not installed.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, List, Sequence

import numpy as np

from ..utils.registry import Registry

if TYPE_CHECKING:
    from PIL import Image

TRANSFORMS = Registry("transforms")


def _per_image(fn: Callable[[Image.Image], Image.Image]):
    from PIL import Image

    def apply(batch: np.ndarray) -> np.ndarray:
        out = []
        for img in batch:
            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                arr = np.clip(arr, 0, 255).astype(np.uint8)
            out.append(np.asarray(fn(Image.fromarray(arr))))
        return np.stack(out)

    return apply


@TRANSFORMS.register(name="resize")
def resize(size: int | Sequence[int] = 256, **_):
    from PIL import Image

    if isinstance(size, int):
        def fn(im: Image.Image) -> Image.Image:
            w, h = im.size
            if w < h:
                return im.resize((size, int(h * size / w)), Image.BILINEAR)
            return im.resize((int(w * size / h), size), Image.BILINEAR)
    else:
        def fn(im: Image.Image) -> Image.Image:
            return im.resize(tuple(size)[::-1], Image.BILINEAR)
    return _per_image(fn)


@TRANSFORMS.register(name="center_crop")
def center_crop(size: int = 224, **_):
    def fn(im: Image.Image) -> Image.Image:
        w, h = im.size
        left, top = (w - size) // 2, (h - size) // 2
        return im.crop((left, top, left + size, top + size))

    return _per_image(fn)


@TRANSFORMS.register(name="random_resized_crop")
def random_resized_crop(size: int = 224, scale: Sequence[float] = (0.08, 1.0), **_):
    from PIL import Image

    rng = np.random.default_rng(0)

    def fn(im: Image.Image) -> Image.Image:
        w, h = im.size
        area = w * h
        for _ in range(10):
            target = area * rng.uniform(*scale)
            ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw, ch = int(round(np.sqrt(target * ar))), int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                left = rng.integers(0, w - cw + 1)
                top = rng.integers(0, h - ch + 1)
                return im.crop((left, top, left + cw, top + ch)).resize((size, size), Image.BILINEAR)
        return im.resize((size, size), Image.BILINEAR)

    return _per_image(fn)


@TRANSFORMS.register(name="random_crop")
def random_crop(size: int = 32, padding: int = 0, **_):
    rng = np.random.default_rng(0)

    def apply(batch: np.ndarray) -> np.ndarray:
        if padding:
            batch = np.pad(batch, ((0, 0), (padding, padding), (padding, padding), (0, 0)))
        n, h, w, _ = batch.shape
        out = np.empty((n, size, size, batch.shape[-1]), batch.dtype)
        for i in range(n):
            top = rng.integers(0, h - size + 1)
            left = rng.integers(0, w - size + 1)
            out[i] = batch[i, top:top + size, left:left + size]
        return out

    return apply


@TRANSFORMS.register(name="random_horizontal_flip")
def random_horizontal_flip(p: float = 0.5, **_):
    rng = np.random.default_rng(0)

    def apply(batch: np.ndarray) -> np.ndarray:
        flips = rng.random(len(batch)) < p
        batch = batch.copy()
        batch[flips] = batch[flips, :, ::-1]
        return batch

    return apply


@TRANSFORMS.register(name="to_tensor")
def to_tensor(**_):
    def apply(batch: np.ndarray) -> np.ndarray:
        return np.asarray(batch, np.float32) / 255.0

    return apply


@TRANSFORMS.register(name="normalize")
def normalize(mean: Sequence[float] = (0.0,), std: Sequence[float] = (1.0,), **_):
    mean_arr = np.asarray(mean, np.float32)
    std_arr = np.asarray(std, np.float32)

    def apply(batch: np.ndarray) -> np.ndarray:
        return (np.asarray(batch, np.float32) - mean_arr) / std_arr

    return apply


@TRANSFORMS.register(name="random_vertical_flip")
def random_vertical_flip(p: float = 0.5, **_):
    rng = np.random.default_rng(0)

    def apply(batch: np.ndarray) -> np.ndarray:
        flips = rng.random(len(batch)) < p
        batch = batch.copy()
        batch[flips] = batch[flips, ::-1]
        return batch

    return apply


@TRANSFORMS.register(name="random_rotation")
def random_rotation(degrees: float | Sequence[float] = 0.0, **_):
    from PIL import Image

    lo, hi = (-degrees, degrees) if isinstance(degrees, (int, float)) else tuple(degrees)
    rng = np.random.default_rng(0)

    def fn(im: Image.Image) -> Image.Image:
        return im.rotate(float(rng.uniform(lo, hi)), resample=Image.BILINEAR)

    return _per_image(fn)


@TRANSFORMS.register(name="random_affine")
def random_affine(degrees: float | Sequence[float] = 0.0,
                  translate: Sequence[float] | None = None,
                  scale: Sequence[float] | None = None,
                  shear: float | Sequence[float] | None = None, **_):
    from PIL import Image

    deg = (-degrees, degrees) if isinstance(degrees, (int, float)) else tuple(degrees)
    shr = None
    if shear is not None:
        shr = (-shear, shear) if isinstance(shear, (int, float)) else tuple(shear)
    rng = np.random.default_rng(0)

    def fn(im: Image.Image) -> Image.Image:
        w, h = im.size
        angle = np.deg2rad(rng.uniform(*deg))
        s = rng.uniform(*scale) if scale else 1.0
        tx = rng.uniform(-translate[0], translate[0]) * w if translate else 0.0
        ty = rng.uniform(-translate[1], translate[1]) * h if translate else 0.0
        sh = np.deg2rad(rng.uniform(*shr)) if shr else 0.0
        # inverse affine about the image center (PIL maps output->input)
        cx, cy = w / 2, h / 2
        ca, sa = np.cos(angle), np.sin(angle)
        a = ca / s
        b = (sa + ca * np.tan(sh)) / s
        d = -sa / s
        e = (ca - sa * np.tan(sh)) / s
        c = cx - a * (cx + tx) - b * (cy + ty)
        f = cy - d * (cx + tx) - e * (cy + ty)
        return im.transform((w, h), Image.AFFINE, (a, b, c, d, e, f),
                            resample=Image.BILINEAR)

    return _per_image(fn)


@TRANSFORMS.register(name="color_jitter")
def color_jitter(brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0, **_):
    from PIL import Image, ImageEnhance

    rng = np.random.default_rng(0)

    def fn(im: Image.Image) -> Image.Image:
        if brightness:
            im = ImageEnhance.Brightness(im).enhance(
                rng.uniform(max(0, 1 - brightness), 1 + brightness))
        if contrast:
            im = ImageEnhance.Contrast(im).enhance(
                rng.uniform(max(0, 1 - contrast), 1 + contrast))
        if saturation:
            im = ImageEnhance.Color(im).enhance(
                rng.uniform(max(0, 1 - saturation), 1 + saturation))
        if hue:
            shift = int(rng.uniform(-hue, hue) * 255)
            hsv = np.asarray(im.convert("HSV")).copy()
            hsv[..., 0] = (hsv[..., 0].astype(np.int16) + shift) % 256
            im = Image.fromarray(hsv, "HSV").convert("RGB")
        return im

    return _per_image(fn)


@TRANSFORMS.register(name="pad")
def pad(padding: int | Sequence[int] = 0, fill: int = 0, **_):
    if isinstance(padding, int):
        pl = pt = pr = pb = padding
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding

    def apply(batch: np.ndarray) -> np.ndarray:
        return np.pad(batch, ((0, 0), (pt, pb), (pl, pr), (0, 0)),
                      constant_values=fill)

    return apply


@TRANSFORMS.register(name="lambda")
def lambda_transform(fn: Callable | None = None, **_):
    return fn if fn is not None else (lambda b: b)


@TRANSFORMS.register(name="random_apply")
def random_apply(transforms: Dict | None = None, p: float = 0.5, **_):
    inner = build_transform(transforms)
    rng = np.random.default_rng(0)

    def apply(batch: np.ndarray) -> np.ndarray:
        return inner(batch) if rng.random() < p else batch

    return apply


@TRANSFORMS.register(name="random_choice")
def random_choice(transforms: Dict | None = None, **_):
    items = [(k, v) for k, v in dict(transforms or {}).items()]
    fns = [TRANSFORMS.build(k, **(dict(v) if isinstance(v, dict) else {}))
           for k, v in items]
    rng = np.random.default_rng(0)

    def apply(batch: np.ndarray) -> np.ndarray:
        return fns[rng.integers(len(fns))](batch) if fns else batch

    return apply


@TRANSFORMS.register(name="random_order")
def random_order(transforms: Dict | None = None, **_):
    items = [(k, v) for k, v in dict(transforms or {}).items()]
    fns = [TRANSFORMS.build(k, **(dict(v) if isinstance(v, dict) else {}))
           for k, v in items]
    rng = np.random.default_rng(0)

    def apply(batch: np.ndarray) -> np.ndarray:
        for i in rng.permutation(len(fns)):
            batch = fns[i](batch)
        return batch

    return apply


@TRANSFORMS.register(name="grayscale")
def grayscale(num_output_channels: int = 1, **_):
    def apply(batch: np.ndarray) -> np.ndarray:
        g = (np.asarray(batch, np.float32)
             @ np.asarray([0.299, 0.587, 0.114], np.float32))
        out = np.repeat(g[..., None], num_output_channels, axis=-1)
        return out.astype(batch.dtype) if batch.dtype == np.uint8 else out

    return apply


@TRANSFORMS.register(name="random_grayscale")
def random_grayscale(p: float = 0.1, **_):
    gray = grayscale(num_output_channels=3)
    rng = np.random.default_rng(0)

    def apply(batch: np.ndarray) -> np.ndarray:
        sel = rng.random(len(batch)) < p
        if not sel.any():
            return batch
        batch = batch.copy()
        batch[sel] = gray(batch[sel])
        return batch

    return apply


@TRANSFORMS.register(name="random_perspective")
def random_perspective(distortion_scale: float = 0.5, p: float = 0.5, **_):
    from PIL import Image

    rng = np.random.default_rng(0)

    def fn(im: Image.Image) -> Image.Image:
        if rng.random() >= p:
            return im
        w, h = im.size
        dx, dy = distortion_scale * w / 2, distortion_scale * h / 2
        quad = [rng.uniform(0, dx), rng.uniform(0, dy),
                rng.uniform(0, dx), h - rng.uniform(0, dy),
                w - rng.uniform(0, dx), h - rng.uniform(0, dy),
                w - rng.uniform(0, dx), rng.uniform(0, dy)]
        return im.transform((w, h), Image.QUAD, quad, resample=Image.BILINEAR)

    return _per_image(fn)


@TRANSFORMS.register(name="random_erasing")
def random_erasing(p: float = 0.5, scale: Sequence[float] = (0.02, 0.33),
                   ratio: Sequence[float] = (0.3, 3.3), value: float = 0.0, **_):
    rng = np.random.default_rng(0)

    def apply(batch: np.ndarray) -> np.ndarray:
        batch = batch.copy()
        n, h, w, _ = batch.shape
        for i in range(n):
            if rng.random() >= p:
                continue
            for _ in range(10):
                area = h * w * rng.uniform(*scale)
                ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
                eh, ew = int(round(np.sqrt(area / ar))), int(round(np.sqrt(area * ar)))
                if eh < h and ew < w:
                    top = rng.integers(0, h - eh + 1)
                    left = rng.integers(0, w - ew + 1)
                    batch[i, top:top + eh, left:left + ew] = value
                    break
        return batch

    return apply


@TRANSFORMS.register(name="five_crop")
def five_crop(size: int = 224, **_):
    def apply(batch: np.ndarray) -> np.ndarray:
        _, h, w, _ = batch.shape
        ct, cl = (h - size) // 2, (w - size) // 2
        corners = [(0, 0), (0, w - size), (h - size, 0), (h - size, w - size),
                   (ct, cl)]
        crops = [batch[:, t:t + size, l:l + size] for t, l in corners]
        return np.concatenate(crops, axis=0)

    return apply


@TRANSFORMS.register(name="ten_crop")
def ten_crop(size: int = 224, **_):
    five = five_crop(size=size)

    def apply(batch: np.ndarray) -> np.ndarray:
        return np.concatenate([five(batch), five(batch[:, :, ::-1])], axis=0)

    return apply


@TRANSFORMS.register(name="linear_transformation")
def linear_transformation(transformation_matrix=None, mean_vector=None, **_):
    mat = np.asarray(transformation_matrix, np.float32)
    mean = (np.asarray(mean_vector, np.float32)
            if mean_vector is not None else np.zeros(mat.shape[0], np.float32))

    def apply(batch: np.ndarray) -> np.ndarray:
        shape = batch.shape
        flat = np.asarray(batch, np.float32).reshape(shape[0], -1) - mean
        return (flat @ mat.T).reshape(shape)

    return apply


@TRANSFORMS.register(name="gaussian_blur")
def gaussian_blur(kernel_size: int = 3, sigma: float | Sequence[float] = (0.1, 2.0), **_):
    from PIL import ImageFilter

    lo, hi = (sigma, sigma) if isinstance(sigma, (int, float)) else tuple(sigma)
    rng = np.random.default_rng(0)

    def fn(im: Image.Image) -> Image.Image:
        return im.filter(ImageFilter.GaussianBlur(float(rng.uniform(lo, hi))))

    return _per_image(fn)


# ---------------------------------------------------------------------------
# Custom training augmentations (reference dataset/transform/augmix.py:16,
# augexpand.py:15, custom_funcs/rotate.py:11-40) — multi-view expansion
# transforms: each input image becomes ``n_views`` stacked views.
# ---------------------------------------------------------------------------

def _augmix_ops():
    from PIL import Image, ImageOps

    def _int_param(level, maxval):
        return int(level * maxval / 10)

    def _float_param(level, maxval):
        return float(level) * maxval / 10.0

    def autocontrast(im, level=None):
        return ImageOps.autocontrast(im)

    def equalize(im, level=None):
        return ImageOps.equalize(im)

    def rotate_op(im, level):
        deg = _int_param(np.random.uniform(low=0.1) * level, 30)
        if np.random.random() > 0.5:
            deg = -deg
        return im.rotate(deg, resample=Image.BILINEAR)

    def solarize(im, level):
        return ImageOps.solarize(im, 256 - _int_param(np.random.uniform(low=0.1) * level, 256))

    def shear_x(im, level):
        s = _float_param(np.random.uniform(low=0.1) * level, 0.3)
        if np.random.random() > 0.5:
            s = -s
        return im.transform(im.size, Image.AFFINE, (1, s, 0, 0, 1, 0),
                            resample=Image.BILINEAR)

    def shear_y(im, level):
        s = _float_param(np.random.uniform(low=0.1) * level, 0.3)
        if np.random.random() > 0.5:
            s = -s
        return im.transform(im.size, Image.AFFINE, (1, 0, 0, s, 1, 0),
                            resample=Image.BILINEAR)

    def translate_x(im, level):
        t = _int_param(np.random.uniform(low=0.1) * level, im.size[0] / 3)
        if np.random.random() > 0.5:
            t = -t
        return im.transform(im.size, Image.AFFINE, (1, 0, t, 0, 1, 0),
                            resample=Image.BILINEAR)

    def translate_y(im, level):
        t = _int_param(np.random.uniform(low=0.1) * level, im.size[1] / 3)
        if np.random.random() > 0.5:
            t = -t
        return im.transform(im.size, Image.AFFINE, (1, 0, 0, 0, 1, t),
                            resample=Image.BILINEAR)

    def posterize(im, level):
        return ImageOps.posterize(im, 4 - _int_param(np.random.uniform(low=0.1) * level, 4))

    return [autocontrast, equalize, rotate_op, solarize, shear_x, shear_y,
            translate_x, translate_y, posterize]


@TRANSFORMS.register(name="augmix")
def augmix(preaugment: Dict | None = None, preprocess: Dict | None = None,
           baseaugment: Dict | None = None, apply_augmix: bool = True,
           n_views: int = 2, severity: int = 1, **_):
    """AugMix multi-view expansion (reference ``augmix.py:95-137``):
    each image yields ``n_views`` views, each a Dirichlet-weighted mix of
    3 random augmentation chains blended with the clean image. Output
    batch has ``n_views * N`` images (views of image i are contiguous)."""
    from PIL import Image

    pre = build_transform(preaugment)
    proc = build_transform(preprocess)
    base = build_transform(baseaugment) if baseaugment else None
    ops = _augmix_ops() if apply_augmix else []

    def one_view(img: np.ndarray) -> np.ndarray:
        x_orig = pre(img[None])[0]
        x_processed = proc(x_orig[None])[0]
        if not ops:
            return x_processed
        w = np.float32(np.random.dirichlet([1.0, 1.0, 1.0]))
        m = np.float32(np.random.beta(1.0, 1.0))
        mix = np.zeros_like(np.asarray(x_processed, np.float32))
        for i in range(3):
            x_aug = Image.fromarray(np.clip(x_orig, 0, 255).astype(np.uint8))
            for _ in range(np.random.randint(1, 4)):
                x_aug = ops[np.random.randint(len(ops))](x_aug, severity)
            mix += w[i] * np.asarray(proc(np.asarray(x_aug)[None])[0], np.float32)
        return m * np.asarray(x_processed, np.float32) + (1 - m) * mix

    def apply(batch: np.ndarray) -> np.ndarray:
        out = []
        for img in batch:
            views = [proc(base(img[None]))[0]] if base else []
            views += [one_view(img) for _ in range(n_views - len(views))]
            out.extend(views)
        return np.stack(out)

    return apply


@TRANSFORMS.register(name="augexpand")
def augexpand(preaugment: Dict | None = None, preprocess: Dict | None = None,
              baseaugment: Dict | None = None,
              custom_funcs: Sequence[str] | None = None, n_views: int = 2, **_):
    """AugExpand multi-view expansion (reference ``augexpand.py:71-104``):
    each view applies one randomly chosen custom function before preprocess."""
    pre = build_transform(preaugment)
    proc = build_transform(preprocess)
    base = build_transform(baseaugment) if baseaugment else None
    funcs = [CUSTOMFUNCS[n] for n in (custom_funcs or [])]

    def one_view(img: np.ndarray) -> np.ndarray:
        x_orig = pre(img[None])[0]
        if not funcs:
            return proc(x_orig[None])[0]
        x_aug = funcs[np.random.randint(len(funcs))](x_orig)
        return proc(np.asarray(x_aug)[None])[0]

    def apply(batch: np.ndarray) -> np.ndarray:
        out = []
        for img in batch:
            views = [proc(base(img[None]))[0]] if base else []
            views += [one_view(img) for _ in range(n_views - len(views))]
            out.extend(views)
        return np.stack(out)

    return apply


def rotate_with_labels(images: Sequence[np.ndarray], labels) -> List[np.ndarray]:
    """Rotate each image by label*90 degrees
    (reference ``custom_funcs/rotate.py:11-26``)."""
    return [np.rot90(img, int(label) % 4, axes=(0, 1))
            for img, label in zip(images, labels)]


def random_rotate(image: np.ndarray) -> np.ndarray:
    """Rotate by a random multiple of 90° (reference ``rotate.py:29-40``)."""
    return rotate_with_labels([image], [np.random.randint(4)])[0]


CUSTOMFUNCS = {"random_rotate": random_rotate}


def build_transform(transform_cfg) -> Callable[[np.ndarray], np.ndarray]:
    """Compose transforms from an ordered config mapping
    (reference ``transforms.py:40-60``)."""
    if transform_cfg is None:
        return lambda b: b
    if hasattr(transform_cfg, "to_dict"):
        transform_cfg = transform_cfg.to_dict()
    fns: List[Callable] = []
    for name, kwargs in dict(transform_cfg).items():
        kwargs = dict(kwargs) if isinstance(kwargs, dict) else {}
        fns.append(TRANSFORMS.build(name, **kwargs))

    def composed(batch: np.ndarray) -> np.ndarray:
        for fn in fns:
            batch = fn(batch)
        return batch

    return composed
