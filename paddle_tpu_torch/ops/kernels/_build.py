"""Build and load the port's CUDA kernels.

Every ``paddle_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into an object file, all
sources at once in parallel, and the objects are linked into ONE shared
library with a plain C interface that :func:`library` loads with
``ctypes``. No PyTorch header is compiled (``torch.utils.cpp_extension``
takes minutes per build); pointers and the stream cross as integers.

The build runs at first use, from the sources in the checkout, into
``paddle_tpu_torch/_build/`` (git-ignored), keyed by a hash of the
sources and flags so an edited kernel rebuilds and an unchanged one is
reused. A file lock serialises concurrent first uses. The build needs a
CUDA toolkit (``$CUDA_HOME``, ``/usr/local/cuda`` or ``nvcc`` on the
``PATH``) and raises when there is none — nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

__all__ = ["library", "build_seconds", "ptxas_report", "ptxas_spills",
           "sass_opcode_counts", "BUILD_DIR", "SOURCES"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
_HEADERS = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_build_seconds: Optional[float] = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "port's CUDA kernels are built from paddle_tpu_torch/csrc at "
            "first use")
    return found


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in SOURCES + _HEADERS:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(out_so: str) -> None:
    nvcc = _nvcc()
    objdir = out_so + ".objs"
    os.makedirs(objdir, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = os.path.join(objdir, os.path.basename(src) + ".o")
        log = open(obj + ".log", "w")
        procs.append((src, obj, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, obj, log, proc in procs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            with open(obj + ".log") as f:
                failed.append(f"{os.path.basename(src)}:\n{f.read()}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = f"{out_so}.{os.getpid()}.tmp"
    subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp,
                    *[p[1] for p in procs]], check=True,
                   capture_output=True)
    os.replace(tmp, out_so)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib, _build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libpaddle_tpu_torch_{_key()}.so")
        t0 = time.perf_counter()
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                if not os.path.exists(so):
                    _compile(so)
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
        _build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        _declare(lib)
        _lib = lib
    return _lib


def build_seconds() -> Optional[float]:
    """Wall seconds :func:`library` spent building (or finding) the
    library in this process; None before the first call."""
    return _build_seconds


def ptxas_report() -> str:
    """What ``ptxas -v`` said about each kernel (registers, shared
    memory, spills) in the last build of this process."""
    so = os.path.join(BUILD_DIR, f"libpaddle_tpu_torch_{_key()}.so")
    out = []
    for log in sorted(glob.glob(so + ".objs/*.log")):
        with open(log) as f:
            out.append(f.read())
    return "".join(out)


def ptxas_spills() -> Dict[str, Tuple[int, int]]:
    """``(spill store bytes, spill load bytes)`` of each kernel (mangled
    name) in :func:`ptxas_report`."""
    out, fn = {}, None
    for ln in ptxas_report().splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn is not None:
            st, ld = int(m.group(1)), int(m.group(2))
            old = out.get(fn, (0, 0))
            out[fn] = (max(old[0], st), max(old[1], ld))
            fn = None
    return out


def sass_opcode_counts(opcode: str) -> Optional[Dict[str, int]]:
    """How many ``opcode`` instructions (e.g. ``HGMMA``, the tensor cores'
    warpgroup product) each kernel (mangled name) of the built library
    holds, from ``cuobjdump -sass``; None where the toolkit has no
    ``cuobjdump``."""
    sass = _sass()
    if sass is None:
        return None
    pattern = re.compile(rf"\b{opcode}\b")
    counts, fn = {}, None
    for ln in sass:
        if "Function : " in ln:
            fn = ln.split("Function : ", 1)[1].split()[0]
            counts.setdefault(fn, 0)
        elif fn is not None and opcode in ln and pattern.search(ln):
            counts[fn] += 1
    return counts


_sass_lines: Optional[list] = None


def _sass() -> Optional[list]:
    """The lines of ``cuobjdump -sass`` over the built library's objects
    (the library links them as they are), one process an object, all
    started together; read once a process. None where the toolkit has
    no ``cuobjdump``."""
    global _sass_lines
    if _sass_lines is not None:
        return _sass_lines
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
        if tool is None:
            return None
    so = os.path.join(BUILD_DIR, f"libpaddle_tpu_torch_{_key()}.so")
    objs = sorted(glob.glob(so + ".objs/*.o")) or [so]
    # each into a file of its own: a full pipe would stall the others
    outs = [tempfile.TemporaryFile(mode="w+") for _ in objs]
    procs = [subprocess.Popen([tool, "-sass", obj], stdout=out,
                              stderr=subprocess.STDOUT, text=True)
             for obj, out in zip(objs, outs)]
    lines = []
    for obj, out, proc in zip(objs, outs, procs):
        proc.wait()
        out.seek(0)
        text = out.read()
        out.close()
        if proc.returncode != 0:
            raise RuntimeError(f"cuobjdump -sass {obj} failed:\n{text}")
        lines.extend(text.splitlines())
    _sass_lines = lines
    return lines


def _declare(lib: ctypes.CDLL) -> None:
    """ctypes signatures of the C entries: every pointer and the stream
    as ``c_void_p`` (a bare int would be cut to 32 bits)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # x, w, y, rows, d, eps, dtype, stream
    lib.ptt_rms_norm_fwd.argtypes = [P, P, P, I, I, F, I, P]
    # q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D, causal, scale, dtype, tma,
    # stream
    lib.ptt_flash_attn_fwd.argtypes = [P] * 5 + [I] * 7 + [F, I, I, P]
    # q, kc, vc, tables, rows, valids, out, T, Hq, Hkv, D, bs, width,
    # scale, q_dtype, kv_dtype, stream
    lib.ptt_ragged_paged_attn.argtypes = [P] * 7 + [I] * 6 + [F, I, I, P]
    # x, w, dy, dx, part, part_rows, dw, rows, d, eps, dtype, stream
    lib.ptt_rms_norm_bwd.argtypes = [P] * 5 + [I, P, I, I, F, I, P]
    # q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D,
    # causal, scale, dtype, tma, stream
    lib.ptt_flash_attn_bwd.argtypes = [P] * 10 + [I] * 7 + [F, I, I, P]
    # q, k, v, resid, wn, wo, wg, wu, wd, out, then the chain's scratch o,
    # lse, h, hn, act, B, S, nh, nkv, D, hidden, ffn, scale, eps, dtype,
    # chain, attn_tma, stream
    lib.ptt_fused_block_fwd.argtypes = [P] * 15 + [I] * 7 + [F, F, I, I, I, P]
    lib.ptt_fused_block_smem_bytes.argtypes = [I, I, I]
    lib.ptt_fused_block_smem_bytes.restype = ctypes.c_longlong
    # x, w1, w2, o1, o2, counts, E, c_pad, K, N, trans_w, x_dtype,
    # w_dtype, tma, stream
    lib.ptt_gmm.argtypes = [P] * 6 + [I] * 8 + [P]
    # x, dy, dw, counts, E, c_pad, K, N, dtype, tma, stream
    lib.ptt_tgmm.argtypes = [P] * 4 + [I] * 6 + [P]
    # q, kc, vc, tables, lens, out, B, Hq, Hkv, D, bs, max_blocks, scale,
    # q_dtype, kv_dtype, stream
    lib.ptt_paged_decode_attn.argtypes = [P] * 6 + [I] * 6 + [F, I, I, P]
    # dtx, la, B, C, y, state, cs, st, batch, lp, H, dh, ds, L, dtype,
    # stream
    lib.ptt_selective_scan.argtypes = [P] * 8 + [I] * 7 + [P]
    # dtx, la, B, C, states, dy, dsf, ddtx, dla, dB, dC, scratch, batch, lp,
    # H, dh, ds, L, dtype, tma, stream
    lib.ptt_selective_scan_bwd.argtypes = [P] * 12 + [I] * 8 + [P]
    # q, kc, vc, k_scale, v_scale, tables, rows, valids, out, T, Hq, Hkv, D,
    # bs, width, scale, q_dtype, page_dtype, stream
    lib.ptt_ragged_paged_attn_quant.argtypes = [P] * 9 + [I] * 6 + [F, I, I, P]
    # q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D, the six seg ints, scale,
    # dtype, tma, stream
    lib.ptt_flash_attn_fwd_seg.argtypes = [P] * 5 + [I] * 12 + [F, I, I, P]
    # q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, the
    # six seg ints, scale, dtype, tma, stream
    lib.ptt_flash_attn_bwd_seg.argtypes = [P] * 10 + [I] * 12 + [F, I, I, P]
    # device, bytes, &ptr, handle (64 bytes) / device, ptr / device,
    # handle, &ptr / device, ptr
    L, PP = ctypes.c_longlong, ctypes.POINTER(P)
    lib.ptt_ipc_alloc.argtypes = [I, L, PP, ctypes.c_char_p]
    lib.ptt_ipc_free.argtypes = [I, P]
    lib.ptt_ipc_open.argtypes = [I, ctypes.c_char_p, PP]
    lib.ptt_ipc_close.argtypes = [I, P]
    # src0, dst0, bytes0, src1, dst1, bytes1, segments, stream
    lib.ptt_ring_copy.argtypes = [P, P, L, P, P, L, I, P]
    # srcs (host array of w pointers), out, block bytes, w, rank, stream
    lib.ptt_a2a_pull.argtypes = [PP, P, L, I, I, P]
    # peers (host array of w pointers), w, rank, bucket, inv, counts, wg,
    # wu, wd, act, y, chunks, e_local, c_pad, M, F, dtype, tma, stream
    lib.ptt_fused_a2a_mlp.argtypes = [PP] + [I] * 3 + [P] * 7 + [I] * 7 + [P]
    # src, dst, bytes, chunks, stream
    lib.ptt_kv_pages_copy.argtypes = [P, P, L, I, P]
    for fn in (lib.ptt_rms_norm_fwd, lib.ptt_flash_attn_fwd,
               lib.ptt_ragged_paged_attn, lib.ptt_rms_norm_bwd,
               lib.ptt_flash_attn_bwd, lib.ptt_fused_block_fwd,
               lib.ptt_gmm, lib.ptt_tgmm, lib.ptt_paged_decode_attn,
               lib.ptt_selective_scan, lib.ptt_selective_scan_bwd,
               lib.ptt_ragged_paged_attn_quant,
               lib.ptt_flash_attn_fwd_seg, lib.ptt_flash_attn_bwd_seg,
               lib.ptt_ipc_alloc, lib.ptt_ipc_free, lib.ptt_ipc_open,
               lib.ptt_ipc_close, lib.ptt_ring_copy, lib.ptt_a2a_pull,
               lib.ptt_fused_a2a_mlp, lib.ptt_kv_pages_copy):
        fn.restype = I
    lib.ptt_error_string.argtypes = [I]
    lib.ptt_error_string.restype = ctypes.c_char_p
