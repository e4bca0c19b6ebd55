"""oisat: an optimal-interpolation data-assimilation framework in JAX.

Re-implementation (from scratch, accelerator-first) of the capabilities of the
OI-SAT-GMI reference pipeline: optimal interpolation between satellite
trace-gas retrievals (OMI, TROPOMI, TEMPO, OMPS, MOPITT, GOSAT, SSMIS) and
chemical-transport-model fields (GMI / HiGMI / ECCOH / CMAQ / FREE).

Design split:
  * host (CPU/Python): file discovery, netCDF/HDF decode, config, reporting,
    regrid *weight construction* (triangulation / KD queries).
  * device (GPU/JAX): every numeric kernel — regrid *apply* (gather +
    weighted sum), vertical observation operators (AMF recal, AK convolution,
    PWV), temporal averaging, and the OI analysis itself — as jitted,
    shardable functions compiled by XLA.

The reference exports a single symbol ``oisatgmi`` (reference
oisatgmi/__init__.py:1); we keep that API, plus the full ops library.
"""

__version__ = "0.1.0"

__all__ = ["oisatgmi", "__version__"]


def _tune_host_allocator():
    """Keep large NumPy temporaries on glibc's reused heap.

    By default glibc serves allocations over ~128 KB with a fresh ``mmap``
    and returns them to the OS on free, so every multi-MB NumPy temporary
    in the per-granule host path (field stacking, affine checks, dtype
    casts) pays first-touch page faults each time — on a VM with slow page
    faults that turns a 14 MB elementwise op from ~10 ms into >200 ms.  Raising ``M_MMAP_THRESHOLD`` (clamped by glibc to 32 MiB)
    and ``M_TRIM_THRESHOLD`` makes those buffers heap-backed and retained,
    so the faults are paid once per size class.  Cost: process RSS stays
    at its high-water mark — the right trade for a dedicated analysis box.
    Disable with ``OISAT_MALLOC_TUNE=0``.
    """
    import ctypes
    import os
    import sys

    if os.environ.get("OISAT_MALLOC_TUNE", "1") != "1":
        return
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 32 * 1024 * 1024)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 256 * 1024 * 1024)  # M_TRIM_THRESHOLD
    except Exception:
        pass  # non-glibc libc: default allocator behavior is fine


_tune_host_allocator()


def __getattr__(name):
    # Lazy import: keep `import oisat` cheap (no jax/h5py import cost)
    if name == "oisatgmi":
        from oisat.driver import oisatgmi

        return oisatgmi
    raise AttributeError(f"module 'oisat' has no attribute {name!r}")
