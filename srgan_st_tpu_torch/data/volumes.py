"""Volumetric data ingestion, NIfTI / TIFF stacks (port of
srgan_st_tpu/data/volumes.py, the port's own copy).

Counterpart of the reference's nifti_reader / data_wrangling notebooks
(SURVEY.md §2.9: DTU bone micro-CT side project — slice extraction from
volumes into training images; not wired into the training loop there
either). Provides a dependency-free NIfTI-1 reader (plain numpy header
parse, .nii / .nii.gz) and TIFF-stack slicing via PIL, plus a slicer that
writes normalized 2D slices ready for prepare_dataset tiling.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

# NIfTI-1 datatype code -> numpy dtype
_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
}


def read_nifti(path: str) -> tuple[np.ndarray, dict]:
    """Minimal NIfTI-1 reader: returns (volume, header_info).

    Supports uncompressed .nii and gzipped .nii.gz single-file images with
    the standard 348-byte header; applies scl_slope/scl_inter when set."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"truncated NIfTI header in {path}")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        if sizeof_hdr != 348:
            raise ValueError(f"not a (little-endian) NIfTI-1 file: {path}")
        if hdr[344:348] not in (b"n+1\x00", b"ni1\x00"):
            raise ValueError(f"missing NIfTI magic in {path}")
        dim = struct.unpack("<8h", hdr[40:56])
        ndim = dim[0]
        shape = tuple(dim[1:1 + ndim])
        datatype = struct.unpack("<h", hdr[70:72])[0]
        if datatype not in _NIFTI_DTYPES:
            raise NotImplementedError(f"NIfTI datatype {datatype}")
        dtype = _NIFTI_DTYPES[datatype]
        vox_offset = int(struct.unpack("<f", hdr[108:112])[0])
        scl_slope = struct.unpack("<f", hdr[112:116])[0]
        scl_inter = struct.unpack("<f", hdr[116:120])[0]
        f.read(max(0, vox_offset - 348))
        count = int(np.prod(shape))
        data = np.frombuffer(f.read(count * np.dtype(dtype).itemsize), dtype=dtype)
    vol = data.reshape(shape[::-1]).transpose(range(ndim)[::-1])  # Fortran order
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        vol = vol.astype(np.float32) * slope + scl_inter
    info = {"shape": shape, "dtype": np.dtype(dtype).name,
            "scl_slope": scl_slope, "scl_inter": scl_inter}
    return vol, info


def read_tiff_stack(path: str) -> np.ndarray:
    """Multi-page TIFF -> (n_pages, H, W[, C]) array (via PIL)."""
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return np.stack([np.asarray(page) for page in ImageSequence.Iterator(im)])


def normalize_slice(sl: np.ndarray, lo_pct: float = 1.0, hi_pct: float = 99.0) -> np.ndarray:
    """Percentile-normalize a 2D slice to uint8 (the notebooks' recipe for
    turning HU-ish volume intensities into trainable images)."""
    sl = sl.astype(np.float32)
    lo, hi = np.percentile(sl, [lo_pct, hi_pct])
    sl = np.clip((sl - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
    return (sl * 255.0 + 0.5).astype(np.uint8)


def slice_volume_to_images(
    volume: np.ndarray, output_dir: str, axis: int = 0, stride: int = 1,
    prefix: str = "slice",
) -> int:
    """Write volume slices as grayscale-replicated RGB PNGs ready for
    prepare_dataset tiling; returns the number written."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    vol = np.moveaxis(volume, axis, 0)
    n = 0
    for i in range(0, vol.shape[0], stride):
        u8 = normalize_slice(vol[i])
        rgb = np.repeat(u8[..., None], 3, axis=-1)
        Image.fromarray(rgb).save(os.path.join(output_dir, f"{prefix}_{i:05d}.png"))
        n += 1
    return n
