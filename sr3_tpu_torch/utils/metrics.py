"""Image conversion and quality metrics (PSNR / SSIM) of the port.

The port's own copy of the JAX package's ``sr3_tpu/utils/metrics.py``, with
the same numbers:

- ``tensor2img``: clamp [-1, 1] -> [0, 1] -> uint8 HWC; a 4-D input becomes
  a sqrt(n)-wide grid. Inputs are NHWC numpy arrays.
- ``save_img`` / ``load_img`` / ``encode_png``: RGB uint8 HWC to and from
  an image file (or encoded bytes), through cv2 and Pillow, else the
  port's PNG codec (``utils/png.py``) for PNG data; anything else without
  cv2 or Pillow raises an error naming what is missing.
- PSNR on [0, 255] in float64.
- SSIM with the MATLAB-convention 11x11 Gaussian window, sigma 1.5, 'valid'
  crop; through cv2 when it is installed, else scipy.

cv2 and Pillow are imported where they are used, never at module level: a
machine may have neither (the card's machine has neither).
"""

from __future__ import annotations

import math

import numpy as np

from sr3_tpu_torch.utils import png


def _cv2():
    """The cv2 module, or None when it is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _pil_image():
    """Pillow's Image module, or None when it is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def make_grid(imgs: np.ndarray, nrow: int, padding: int = 2) -> np.ndarray:
    """(N,H,W,C) -> grid (H',W',C), torchvision.utils.make_grid semantics
    (pad=2, value 0)."""
    n, h, w, c = imgs.shape
    ncol = int(math.ceil(n / nrow))
    grid = np.zeros(
        (h * ncol + padding * (ncol + 1), w * nrow + padding * (nrow + 1), c),
        dtype=imgs.dtype)
    for idx in range(n):
        r, col = divmod(idx, nrow)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y:y + h, x:x + w] = imgs[idx]
    return grid


def tensor2img(tensor, out_type=np.uint8, min_max=(-1, 1)):
    """NHWC (or HWC / HW) array in [min_max] -> uint8 HWC image. A 4-D
    input with N>1 becomes a sqrt(N)-wide grid; singleton dims are
    squeezed."""
    img = np.squeeze(np.asarray(tensor, dtype=np.float32))
    img = np.clip(img, min_max[0], min_max[1])
    img = (img - min_max[0]) / (min_max[1] - min_max[0])
    if img.ndim == 4:
        img = make_grid(img, nrow=int(math.sqrt(img.shape[0])))
    elif img.ndim not in (2, 3):
        raise TypeError(f"Only 4D, 3D, 2D supported; got {img.ndim}D")
    if out_type == np.uint8:
        img = (img * 255.0).round()
    return img.astype(out_type)


def save_img(img, img_path):
    """RGB uint8 HWC -> image file (cv2, else Pillow, else the port's PNG
    codec for a .png path)."""
    cv2 = _cv2()
    if cv2 is not None:
        cv2.imwrite(img_path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        return
    Image = _pil_image()
    if Image is not None:
        Image.fromarray(img).save(img_path)
        return
    if not img_path.lower().endswith(".png"):
        raise ValueError(f"cannot write {img_path}: without cv2 or Pillow "
                         "the port writes PNG only")
    with open(img_path, "wb") as f:
        f.write(png.encode(img))


def encode_png(img):
    """RGB uint8 HWC -> PNG bytes (Pillow, as the JAX package's prepare
    writes its LMDB, else the port's codec)."""
    Image = _pil_image()
    if Image is None:
        return png.encode(img)
    from io import BytesIO

    buf = BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def load_img(src, first="cv2"):
    """Image file path or encoded bytes -> RGB uint8 HWC, through cv2 and
    Pillow in the order ``first`` ("cv2" or "pil") names, the first one
    installed; without either, PNG data through the port's codec."""
    for lib in (("cv2", "pil") if first == "cv2" else ("pil", "cv2")):
        if lib == "cv2" and (cv2 := _cv2()) is not None:
            if isinstance(src, (bytes, bytearray)):
                bgr = cv2.imdecode(np.frombuffer(src, np.uint8),
                                   cv2.IMREAD_COLOR)
            else:
                bgr = cv2.imread(src, cv2.IMREAD_COLOR)
            return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        if lib == "pil" and (Image := _pil_image()) is not None:
            from io import BytesIO

            f = BytesIO(src) if isinstance(src, (bytes, bytearray)) else src
            with Image.open(f) as img:
                return np.asarray(img.convert("RGB"))
    return png.to_rgb(png.decode(src))


def calculate_psnr(img1, img2):
    """PSNR between uint8 [0,255] images."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _gaussian_window():
    """11-tap Gaussian kernel, sigma 1.5, outer product (as
    cv2.getGaussianKernel(11, 1.5))."""
    xs = np.arange(11) - 5.0
    k = np.exp(-(xs ** 2) / (2 * 1.5 ** 2))
    k = (k / k.sum()).reshape(-1, 1)
    return np.outer(k, k.T)


def _filter2d_valid(img, window):
    """Correlation with ``window`` over the valid region (as
    cv2.filter2D(...)[5:-5, 5:-5])."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.filter2D(img, -1, window)[5:-5, 5:-5]
    from scipy.signal import fftconvolve

    if img.ndim == 3:
        return np.stack([fftconvolve(img[..., ch], window[::-1, ::-1],
                                     mode="valid")
                         for ch in range(img.shape[2])], axis=-1)
    return fftconvolve(img, window[::-1, ::-1], mode="valid")


def ssim(img1, img2):
    """Single-pass SSIM."""
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _gaussian_window()

    mu1 = _filter2d_valid(img1, window)
    mu2 = _filter2d_valid(img2, window)
    mu1_sq = mu1 ** 2
    mu2_sq = mu2 ** 2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _filter2d_valid(img1 ** 2, window) - mu1_sq
    sigma2_sq = _filter2d_valid(img2 ** 2, window) - mu2_sq
    sigma12 = _filter2d_valid(img1 * img2, window) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()


def calculate_ssim(img1, img2):
    """SSIM between uint8 [0,255] images, MATLAB convention; a 3-channel
    image is filtered per channel once."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return ssim(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return ssim(img1, img2)
        if img1.shape[2] == 1:
            return ssim(np.squeeze(img1), np.squeeze(img2))
    raise ValueError("Wrong input image dimensions.")
