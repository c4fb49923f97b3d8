"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

No `sofima_tpu` twin: the reference's Pallas kernels compile inside jit.
Here every `csrc/*.cu` is compiled at first use, on the machine with the
card, into ONE shared library with a plain C interface. The sources
compile in parallel, one nvcc each, then link:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
       -Xcompiler -fPIC -Xptxas -v -c -o <build>/<hash>/<name>.o <name>.cu
  nvcc -shared -o <build>/<hash>/libsofima_kernels.so <build>/<hash>/*.o

The build directory is keyed by a hash of the sources (`*.cu`, `*.cuh`)
and flags, so an edited kernel rebuilds and an unchanged one loads in
milliseconds. It lives under `build/` beside the package (listed in
.gitignore), or under $SOFIMA_TORCH_BUILD_DIR. `--use_fast_math` is
deliberately absent: it changes the NaN, inf and rsqrt behaviour that
the mesh solvers and the peak chain depend on.

Importing this module needs no nvcc and no card; only `library()` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / 'csrc'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_lib = None
# Seconds the last build (or cached load) of the library took, and the
# compiler's per-kernel register / shared-memory report.
build_seconds: float | None = None
build_log: str = ''

# Launches per kernel entry, incremented by each wrapper exactly where it
# launches its kernel (never on the CPU path), through `count`: the
# processor runner launches from several threads at once.
launch_counts: dict[str, int] = {
    'dense_flow_peaks': 0,      # K1: coarse pass
    'targeted_flow_peaks': 0,   # K2: fine pass
    'flow_peaks_dft': 0,        # K1/K2's dense-DFT route (also counted
                                # above; sizes the FFT route does not serve)
    'masked_flow_peaks': 0,     # K5's dense-DFT route (impure pairs)
    'masked_flow_pure': 0,      # K5's pure route (shared-memory FFT)
    'patch_flow_peaks': 0,      # K6's FFT route: peaks of pre-cut patch
                                # batches (shared-memory FFT)
    'patch_flow_peaks_dft': 0,  # K6's dense-DFT route (shapes the FFT
                                # route does not serve)
    'corr_patches': 0,          # K7: surfaces of pre-cut patch batches
    'fused_fire': 0,            # K3: mesh solve
    'warp_gather': 0,           # K4: render
    'warp_subvolume': 0,        # K4 gather for warp.warp_subvolume (K4p)
    'ndimage_warp': 0,          # K4 gather for 2d warp.ndimage_warp (K12)
    'force2d': 0,               # K8: 2d mesh force
    'force3d': 0,               # K9: 3d mesh force
    'fused_fire_3d': 0,         # K11: 3d mesh solve
    'fused_fire_grid': 0,       # K3 / K11's grid-stride route (also
                                # counted above; meshes whose tiles the
                                # card cannot hold at once)
    'warp_gather_3d': 0,        # K13: 3d render
    'invert_section': 0,        # 2d map inversion (csrc/invert.cu)
    'fill_invalid': 0,          # 2d hole fill: each of its launches
}


_count_lock = threading.Lock()


def count(name: str, n: int = 1) -> None:
  """Adds n launches of `name`; exact when several threads launch."""
  with _count_lock:
    launch_counts[name] += n


def reset_launch_counts() -> None:
  with _count_lock:
    for k in launch_counts:
      launch_counts[k] = 0


def _build_root() -> pathlib.Path:
  env = os.environ.get('SOFIMA_TORCH_BUILD_DIR')
  if env:
    return pathlib.Path(env)
  return CSRC.parent.parent / 'build' / 'sofima_tpu_torch'


def _nvcc() -> str:
  for cand in (os.environ.get('NVCC'),
               os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
               shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
    if cand and os.path.isfile(cand):
      return cand
  raise RuntimeError('nvcc not found: the CUDA kernels build only where the '
                     'CUDA toolkit is installed (set CUDA_HOME or NVCC)')


def library() -> ctypes.CDLL:
  """Builds (once per source hash) and loads the kernel library."""
  global _lib, build_seconds, build_log
  if _lib is not None:  # loaded: no lock on the launch path
    return _lib
  with _lock:
    if _lib is not None:
      return _lib
    t0 = time.perf_counter()
    sources = sorted(CSRC.glob('*.cu'))
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob('*.cuh')):
      digest.update(src.name.encode())
      digest.update(src.read_bytes())
    out_dir = _build_root() / digest.hexdigest()[:16]
    so_path = out_dir / 'libsofima_kernels.so'
    log_path = out_dir / 'build.log'
    if not so_path.exists():
      out_dir.mkdir(parents=True, exist_ok=True)
      _compile(sources, out_dir, so_path, log_path)
    build_log = log_path.read_text() if log_path.exists() else ''
    _lib = ctypes.CDLL(str(so_path))
    build_seconds = time.perf_counter() - t0
    return _lib


def _compile(sources, out_dir: pathlib.Path, so_path: pathlib.Path,
             log_path: pathlib.Path) -> None:
  """One nvcc per source, all started together, then one link."""
  nvcc = _nvcc()
  tag = f'.tmp{os.getpid()}'
  jobs = []
  for src in sources:
    obj = out_dir / f'{src.stem}{tag}.o'
    cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
    jobs.append((cmd, obj, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
  log, failed = [], []
  for cmd, _, proc in jobs:
    out, _ = proc.communicate()
    log.append(' '.join(cmd) + '\n' + out)
    if proc.returncode != 0:
      failed.append(log[-1])
  if failed:
    log_path.write_text('\n'.join(log))
    raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
  tmp = out_dir / f'libsofima_kernels{tag}.so'
  cmd = [nvcc, '-shared', '-o', str(tmp), *(str(o) for _, o, _ in jobs)]
  proc = subprocess.run(cmd, capture_output=True, text=True)
  log.append(' '.join(cmd) + '\n' + proc.stdout + proc.stderr)
  log_path.write_text('\n'.join(log))
  if proc.returncode != 0:
    raise RuntimeError('nvcc link failed:\n' + log[-1])
  os.replace(tmp, so_path)
  for _, obj, _ in jobs:
    obj.unlink()


def check(rc: int, name: str) -> None:
  """Raises on a non-zero cudaError_t returned by a launch function."""
  if rc != 0:
    raise RuntimeError(f'{name}: CUDA error {rc}')


def stream_of(t: torch.Tensor) -> int:
  """The current stream of t's card, as a raw handle. The C hook returns
  it directly: torch.cuda.current_stream builds a Stream object, a
  third of a small launch's host time."""
  return torch._C._cuda_getCurrentRawStream(t.get_device())


def require_cuda(name: str, *tensors: torch.Tensor,
                 dtype=torch.float32) -> None:
  """Kernel preconditions: one CUDA device, dtype, contiguity."""
  dev = tensors[0].get_device()
  for t in tensors:
    if not t.is_cuda or t.get_device() != dev:
      raise ValueError(f'{name}: all tensors must be on one CUDA device')
    if t.dtype != dtype:
      raise TypeError(f'{name}: expected {dtype}, got {t.dtype}')
    if not t.is_contiguous():
      raise ValueError(f'{name}: tensors must be contiguous')


def ptr(t: torch.Tensor | None) -> int | None:
  return None if t is None else t.data_ptr()
