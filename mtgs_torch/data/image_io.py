"""Image decoding and resizing for the data layer, without an imaging package.

The JAX package reads its camera JPEGs and mask PNGs with PIL
(`mtgs_tpu/data/dataset.py`); the port brings its own decoders so that it
runs where no imaging package is installed:

* `read_image(path)` — the array `np.asarray(PIL.Image.open(path))` gives,
  chosen by the file's magic bytes. Baseline JPEG (SOF0/SOF1, 8-bit,
  Huffman; grey or YCbCr/RGB; any integer sampling, restart intervals) is
  decoded by `csrc/image_decode.cc`, which follows libjpeg's integer IDCT,
  fancy upsampling and colour tables so its pixels are PIL's. PNG: the
  concatenated IDATs are inflated with `zlib`, the row filters undone in
  C++; colour types 0/2/3/4/6 at 8 bits, grey at 1/2/4 bits (mode "1" as a
  bool array, 2 and 4 bits scaled to 0..255 as PIL does) and 16 bits
  (uint16), palette images at 1-8 bits as their indices. Progressive,
  arithmetic-coded, 12-bit and CMYK JPEGs, interlaced PNGs and 16-bit colour
  PNGs raise ValueError naming the file and the reason.
* `to_luma(path)` — `np.asarray(PIL.Image.open(path).convert("L"))`:
  PIL's integer luma (R*19595 + G*38470 + B*7471 + 0x8000) >> 16.
* `resize(img, scale, nearest)` — `dataset.py::_resize`, PIL's resize of
  mode "F" images: bilinear is PIL's separable resample (float64 weights,
  a horizontal pass rounded to float32, then a vertical pass, each tap
  accumulated in PIL's order), nearest PIL's affine scale (source
  coordinates accumulated in float64).

The eval and export layers write and resample uint8 images as PIL does,
through `csrc/image_encode.cc`:

* `write_jpeg(path, rgb_u8)` — the bytes of `PIL.Image.fromarray(rgb).save(path)`
  for a .jpg path: baseline JPEG at PIL's defaults (quality 75, 4:2:0,
  libjpeg's islow DCT and standard Huffman tables).
* `resize_u8(img_u8, (w, h), nearest, bicubic)` —
  `np.asarray(PIL.Image.fromarray(img).resize((w, h), NEAREST, BILINEAR or
  BICUBIC))` for uint8 [H, W] or [H, W, 3]: PIL's 8-bit resample (22-bit
  fixed-point weights), not its float one.

The C++ libraries are compiled on first use by the host compiler (`$CXX`,
else `c++`) into `build/mtgs_torch/`, under a name that hashes the source and
the flags; nothing is built at import. ctypes releases the GIL during a
call, so `SampleCache`'s threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "image_decode.cc"
ENCODE_SOURCE = CSRC / "image_encode.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mtgs_torch"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

_LIB: Optional[ctypes.CDLL] = None
_ENC_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_ERR_LEN = 256


def _compiler(source: Path) -> str:
    cxx = os.environ.get("CXX") or "c++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(
            f"mtgs_torch: no C++ compiler {cxx!r} on PATH; mtgs_torch/csrc/{source.name} "
            f"(the image decoders, the JPEG encoder and uint8 resize, or the ICP core) is "
            f"built with it on first use")
    return path


def library_path(source: Path = SOURCE, flags: Tuple[str, ...] = CXX_FLAGS) -> Path:
    """Where the library of this source and these flags lives. A
    `-march=native` build also hashes the compiler's macros for this host's
    CPU, so a build directory carried to another machine is not reused."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(flags).encode())
    if "-march=native" in flags:
        proc = subprocess.run([_compiler(source), "-march=native", "-dM", "-E", "-x", "c++",
                               os.devnull], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        h.update(proc.stdout)
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, flags: Tuple[str, ...] = CXX_FLAGS) -> Path:
    """Compile a host library (the decoders by default) unless it exists;
    returns its path. The library is written under a temporary name and
    renamed into place, so processes building at once agree. Raises with
    the compiler's output."""
    out = library_path(source, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(source), *flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"mtgs_torch: building {source.name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return out


def _enc_lib() -> ctypes.CDLL:
    global _ENC_LIB
    with _LOCK:
        if _ENC_LIB is None:
            lib = ctypes.CDLL(str(build(ENCODE_SOURCE)))
            u8p, i64, i32, cp = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_char_p
            lib.mtgs_jpeg_bound.argtypes = [i32, i32]
            lib.mtgs_jpeg_bound.restype = i64
            lib.mtgs_jpeg_encode.argtypes = [u8p, i32, i32, i32, u8p, i64, cp, i32]
            lib.mtgs_jpeg_encode.restype = i64
            lib.mtgs_resize_u8.argtypes = [u8p, i32, i32, i32, u8p, i32, i32, i32, cp, i32]
            lib.mtgs_resize_u8.restype = i32
            _ENC_LIB = lib
        return _ENC_LIB


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            u8p, i64, ip, cp = (ctypes.c_void_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int), ctypes.c_char_p)
            lib.mtgs_jpeg_info.argtypes = [u8p, i64, ip, ip, ip, cp, ctypes.c_int]
            lib.mtgs_jpeg_info.restype = ctypes.c_int
            lib.mtgs_jpeg_decode.argtypes = [u8p, i64, u8p, i64, cp, ctypes.c_int]
            lib.mtgs_jpeg_decode.restype = ctypes.c_int
            lib.mtgs_png_unfilter.argtypes = [u8p, i64, ctypes.c_int, i64, ctypes.c_int, u8p,
                                              cp, ctypes.c_int]
            lib.mtgs_png_unfilter.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _decode_jpeg(data: bytes, path) -> np.ndarray:
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.mtgs_jpeg_info(_ptr(buf), buf.size, ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(c), err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    out = np.empty((h.value, w.value, c.value), np.uint8)
    if lib.mtgs_jpeg_decode(_ptr(buf), buf.size, _ptr(out), out.size, err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    return out[..., 0] if c.value == 1 else out


# PNG colour type -> (channels, the bit depths decoded)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)), 4: (2, (8,)),
              6: (4, (8,))}


def _read_png(data: bytes, path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(the array PIL gives, the palette [n, 3] of a palette image or None)."""
    pos, ihdr, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {tag!r}")
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or image data")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: unsupported: interlaced (Adam7) PNG")
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1]:
        raise ValueError(f"{path}: unsupported: PNG colour type {ctype} at {depth} bits "
                         f"(16-bit colour is not decoded)")
    ch = _PNG_TYPES[ctype][0]
    bits = depth * ch
    stride = (w * bits + 7) // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    rows = np.empty((h, stride), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _lib().mtgs_png_unfilter(_ptr(raw), raw.size, h, stride, max(bits // 8, 1), _ptr(rows),
                                err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        img = rows.reshape(h, w, ch) if ch > 1 else rows
    else:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        img = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, stride * per)[:, :w]
        if ctype == 0:
            img = img.astype(bool) if depth == 1 else img * np.uint8(255 // ((1 << depth) - 1))
    return img, palette if ctype == 3 else None


def _read_checked(path) -> bytes:
    """The file's bytes; raises unless it starts as a JPEG or a PNG."""
    data = Path(path).read_bytes()
    if data[:3] == b"\xff\xd8\xff":
        return data
    if data[:8] == PNG_MAGIC:
        return data
    raise ValueError(f"{path}: not a JPEG or PNG file (magic bytes {data[:8]!r})")


def read_image(path) -> np.ndarray:
    """The decoded image, as `np.asarray(PIL.Image.open(path))` gives it:
    uint8 [H, W] grey, [H, W, 2] grey+alpha, [H, W, 3] RGB, [H, W, 4] RGBA,
    bool [H, W] for 1-bit grey, uint16 [H, W] for 16-bit grey, palette
    indices uint8 [H, W] for a palette PNG."""
    data = _read_checked(path)
    if data[:2] == b"\xff\xd8":
        return _decode_jpeg(data, path)
    return _read_png(data, path)[0]


def to_rgb(img: np.ndarray) -> np.ndarray:
    """`PIL.Image.convert("RGB")` of a decoded 8-bit grey, grey + alpha, RGB
    or RGBA array: grey replicated, alpha dropped."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):
        img = img[..., :1]
    return np.ascontiguousarray(np.broadcast_to(img[..., :3], img.shape[:2] + (3,)))


def _luma24(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def to_luma(path) -> np.ndarray:
    """uint8 [H, W]: `np.asarray(PIL.Image.open(path).convert("L"))`."""
    data = _read_checked(path)
    if data[:2] == b"\xff\xd8":
        img = _decode_jpeg(data, path)
        return img if img.ndim == 2 else _luma24(img)
    img, palette = _read_png(data, path)
    if palette is not None:
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return _luma24(full[img])
    if img.dtype == bool:
        return img.astype(np.uint8) * np.uint8(255)
    if img.dtype == np.uint16:
        return np.minimum(img, 255).astype(np.uint8)
    if img.ndim == 2:
        return img
    return img[..., 0] if img.shape[-1] == 2 else _luma24(img)


def _bilinear_taps(n_in: int, n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """PIL's `precompute_coeffs` for the bilinear filter (support 1):
    (source index [n_out, ksize] int64, normalised weight [n_out, ksize]
    float64); taps past a row's bound carry weight 0 and index 0."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((n_out, ksize), np.int64)
    wts = np.zeros((n_out, ksize), np.float64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        x = np.arange(xmax)
        w = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) * (1.0 / filterscale)), 0.0)
        ww = 0.0
        for v in w:  # PIL's sequential sum of the weights
            ww += v
        if ww != 0.0:
            w = w / ww
        idx[xx, :xmax] = x + xmin
        wts[xx, :xmax] = w
    return torch.from_numpy(idx), torch.from_numpy(wts)


def _resample_axis(img: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """One separable pass of PIL's float resample along `axis` (0 rows, 1
    columns): each output a float64 sum over its taps in PIL's order,
    rounded to float32."""
    n_in = img.shape[axis]
    idx, wts = _bilinear_taps(n_in, n_out)
    src = img.to(torch.float64)
    acc = torch.zeros((n_out, src.shape[1]) if axis == 0 else (src.shape[0], n_out),
                      dtype=torch.float64)
    for k in range(idx.shape[1]):
        if axis == 0:
            acc += src[idx[:, k]] * wts[:, k, None]
        else:
            acc += src[:, idx[:, k]] * wts[None, :, k]
    return acc.to(torch.float32)


def _nearest_index(n_in: int, n_out: int) -> torch.Tensor:
    """PIL's ImagingScaleAffine source index: x0 = scale/2, then += scale,
    accumulated in float64 and truncated."""
    scale = n_in / n_out
    steps = np.full(n_out, scale, np.float64)
    steps[0] = scale * 0.5
    pos = np.add.accumulate(steps)
    return torch.from_numpy(np.minimum(pos.astype(np.int64), n_in - 1))


def resize(img: np.ndarray, scale: float, nearest: bool = False) -> np.ndarray:
    """`mtgs_tpu/data/dataset.py::_resize`: [H, W] or [H, W, C] to
    (round(H * scale), round(W * scale)) as PIL resizes each channel as a
    mode "F" image (non-uint8 inputs are cast to float32 first, as there);
    returns float32. Bilinear or nearest."""
    if scale == 1.0:
        return img
    if img.dtype == np.uint8:
        raise ValueError("resize takes float images (the data layer resizes no uint8 image)")
    h, w = img.shape[:2]
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    flat = x.reshape(h, w, -1)
    if nearest:
        out = flat[_nearest_index(h, nh)][:, _nearest_index(w, nw)]
    else:
        # PIL resamples horizontally first, then vertically, skipping a pass
        # whose size is unchanged
        chans = []
        for c in range(flat.shape[-1]):
            ch = flat[..., c]
            if nw != w:
                ch = _resample_axis(ch, nw, axis=1)
            if nh != h:
                ch = _resample_axis(ch, nh, axis=0)
            chans.append(ch)
        out = torch.stack(chans, -1)
    out = out.numpy()
    return out[..., 0] if img.ndim == 2 else out


def encode_jpeg(rgb_u8: np.ndarray, quality: int = 75) -> bytes:
    """The baseline JPEG bytes PIL writes for an RGB uint8 [H, W, 3] image
    with `save(..., quality=quality)` (4:2:0; PIL's default quality is 75)."""
    img = np.asarray(rgb_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes RGB uint8 [H, W, 3], got {img.dtype} {img.shape}")
    if not 1 <= int(quality) <= 100:
        raise ValueError(f"encode_jpeg: quality {quality} outside 1..100")
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    lib = _enc_lib()
    out = np.empty(lib.mtgs_jpeg_bound(h, w), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    n = lib.mtgs_jpeg_encode(_ptr(img), h, w, int(quality), _ptr(out), out.size, err, _ERR_LEN)
    if n < 0:
        raise ValueError(f"encode_jpeg: {err.value.decode()}")
    return out[:n].tobytes()


def write_jpeg(path, rgb_u8: np.ndarray, quality: int = 75) -> Path:
    """Write an RGB uint8 [H, W, 3] image as the JPEG file
    `PIL.Image.fromarray(rgb_u8).save(path, quality=quality)` writes for a
    .jpg path."""
    path = Path(path)
    path.write_bytes(encode_jpeg(rgb_u8, quality))
    return path


def resize_u8(img_u8: np.ndarray, size: Tuple[int, int], nearest: bool = False,
              bicubic: bool = False) -> np.ndarray:
    """`np.asarray(PIL.Image.fromarray(img).resize(size, NEAREST, BILINEAR
    or BICUBIC))` for uint8 [H, W] (mode "L") or [H, W, C]; size is (width,
    height). BICUBIC (`bicubic=True`) is what `Image.resize` takes when given
    no filter."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_u8 takes uint8 [H, W] or [H, W, C], got {img.dtype} "
                         f"{img.shape}")
    if nearest and bicubic:
        raise ValueError("resize_u8: nearest or bicubic, not both")
    h, w = img.shape[:2]
    ow, oh = int(size[0]), int(size[1])
    if ow < 1 or oh < 1:
        raise ValueError(f"resize_u8: target size {size}")
    if (ow, oh) == (w, h):
        return img.copy()
    if nearest:
        rows = _nearest_index(h, oh).numpy()
        cols = _nearest_index(w, ow).numpy()
        return img[rows][:, cols]
    src = np.ascontiguousarray(img)
    c = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((oh, ow) + img.shape[2:], np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _enc_lib().mtgs_resize_u8(_ptr(src), h, w, c, _ptr(out), oh, ow, int(bicubic), err,
                                 _ERR_LEN):
        raise ValueError(f"resize_u8: {err.value.decode()}")
    return out
