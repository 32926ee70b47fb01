"""Build and load the hand-written CUDA kernels of `stgcma_tpu_torch/csrc/`.

Each `.cu` source is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface, all sources at once in parallel, on first
use. The libraries land in `build/kernels/<hash>/` at the root of the
checkout, keyed on a hash of every file in `csrc/`, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing is built or loaded
when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# C signature of every exported launcher (all return a cudaError_t as int)
SIGNATURES = {
    "rowprep.cu": {
        # x, gamma, beta, y, M, K (a multiple of 8 up to 4096; every pointer 16-byte
        # aligned), eps, stream
        "stg_ln_bf16": [P, P, P, P, I, I, F, P],
        # x0, x1, M0 (rows [0, M0) of x0, then of x1), gamma, beta, y, M, K, eps, stream
        "stg_ln_bf16_pair": [P, P, I, P, P, P, I, I, F, P],
        # x, x_is_f32, gamma (nullable: no LN), beta, amax (nullable: the rows' given
        # max |x|, no LN), q, sx, M, K, eps, stream
        "stg_quant_rows": [P, I, P, P, P, P, P, I, I, F, P],
        # x0, x1, M0, gamma, beta, q, sx, M, K, eps, stream: LN of bf16 rows rounded to
        # bf16, then quantized (K4's int8 variant)
        "stg_ln_quant_rows_bf16": [P, P, I, P, P, P, P, I, I, F, P],
    },
    "gemm.cu": {
        # A, W, bias, C, M, N, K, epilogue (0: + bias, 4: + bias -> erf-GELU,
        # 5: + bias -> bf16 -> erf-GELU, 7: + bias -> QuickGELU), stream
        "stg_gemm_bf16": [P, P, P, P, I, I, I, I, P],
        # A, W, bias, R1, R2, C, M, N, K, stream: C = bf16(bf16(R1 + R2) + bf16(A.W^T + b))
        "stg_gemm_bf16_res2": [P, P, P, P, P, P, I, I, I, P],
        # A, W, bias, R, C, M, N, K, epilogue (9: C = bf16(R + (A.W^T + b)), one rounding;
        # 8: bf16(R + bf16(A.W^T + b))), stream
        "stg_gemm_bf16_res": [P, P, P, P, P, I, I, I, I, P],
        # A, sa, W, ws, bias, C, amax (nullable; the fp32 epilogues 2, 3 take each row's
        # max |C| into it), M, N, K, epilogue (1: bf16, 2: QuickGELU, 3: erf-GELU), stream
        "stg_gemm_s8": [P, P, P, P, P, P, P, I, I, I, I, P],
    },
    "ffn.cu": {
        # x, gamma, beta, w1, b1, w2, b2, out, M, C (128, 192, 256 or 384; hidden 4C), eps,
        # stream: out = bf16(bf16(gelu(bf16(LN(x)) . w1^T + b1)) . w2^T + b2), the hidden
        # on chip (K7)
        "stg_ffn_bf16": [P, P, P, P, P, P, P, P, I, I, F, P],
    },
    "attn.cu": {
        # qkv, bm (nullable), nWb, o, B_, N, heads, dh, scale, stream
        "stg_attn_core": [P, P, I, P, I, I, I, I, F, P],
        # qkv (B, T, Ns, 3C), bm (nullable, (heads, T, T)), o, B, T, Ns, heads, dh, scale,
        # stream: attention over the T frames of each token
        "stg_attn_core_t": [P, P, P, I, I, I, I, I, F, P],
        # q (pre-scaled), k, v, bm, P, o, R, N, dh, stream
        "stg_attn_qkv": [P, P, P, P, I, P, I, I, I, P],
        # qkv (B, ntok, 3C), bm (nullable, (1, heads, ntok, ntok)), table (nW * n,), nW, o,
        # B, ntok, n, heads, dh, scale, stream: attention within each window (K4)
        "stg_attn_core_win": [P, P, P, I, P, I, I, I, I, I, F, P],
    },
    "fuse.cu": {
        # vh, ah, gv, ga, mask (nullable), vo, ao, B, Nv, Na, D, stream
        "stg_fuse_bidir": [P, P, P, P, P, P, P, I, I, I, I, P],
        # vh, ah, gv, ga, table (nW * n,), nW, vo, ao, B, ntok, n, D, stream: the fusion
        # within each window (K4's S_Adapter2)
        "stg_fuse_bidir_win": [P, P, P, P, P, I, P, P, I, I, I, I, P],
        # q, k, v, o, B, Nq, Nk, D, stream: o = softmax(q.k^T).v, unscaled
        "stg_unscaled_attn": [P, P, P, P, I, I, I, I, P],
    },
    "tattn.cu": {
        # A, W, bias, O, M, C, T, heads, N, scale, stream: O (M, C) = merged heads of each
        # sequence's attention over its T frames (N 0: T consecutive rows; N > 0: one
        # token's frames of the (M / (T N), T, N, C) layout), qkv = A . W^T + bias never
        # stored
        "stg_tattn_bf16": [P, P, P, P, I, I, I, I, I, F, P],
        # A, sa, W, ws, bias, O, M, C, T, heads, N, scale, stream: the same from int8 codes
        "stg_tattn_s8": [P, P, P, P, P, P, I, I, I, I, I, F, P],
    },
    "rowadapt.cu": {
        # A, W, bias, O (nullable), wd, bd, H (nullable), w2 (nullable), b2, X, Y, M, N, K,
        # D, down epilogue (0, 4, 5 as gemm.cu's), up epilogue (8, 9 as gemm.cu's), stream:
        # O = bf16(A . W^T + bias), H = epi(O . wd^T + bd), Y = bf16(X + bf16(H . w2^T +
        # b2)) (8) or bf16(X + (H . w2^T + b2)) (9)
        "stg_rowadapt_bf16": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
        # A, sa, W, ws, bias, then as the bf16 one: the same from int8 codes
        "stg_rowadapt_s8": [P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
    },
    "adapter.cu": {
        # xv, wv, bv, hv, xa, wa, ba, ha, M, D, K, stream: both streams' adapter hiddens
        # bf16(gelu(bf16(x.W^T + b))) (K4)
        "stg_adapter_hidden_pair": [P, P, P, P, P, P, P, P, I, I, I, P],
        # fv, wv, bv, r1v, r2v, yv, fa, wa, ba, r1a, r2a, ya, M, N, K, stream: both streams'
        # adapter outputs bf16(bf16(r1 + r2) + bf16(f.W^T + b)) (K4)
        "stg_adapter_out_pair": [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home}/bin)")
    return path


def build() -> Path:
    """Compile every source that has no library for the current hash yet.
    Returns the build directory, which also holds each source's nvcc log
    (`<source>.log`, with ptxas' register and spill counts). Raises with
    nvcc's output if a source fails."""
    out_dir = BUILD_ROOT / sources_hash()
    todo = [src for src in SIGNATURES if not (out_dir / _so_name(src)).exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = out_dir / f"tmp{os.getpid()}_{_so_name(src)}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"{src}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
        else:
            os.replace(tmp, out_dir / _so_name(src))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out_dir


def _so_name(src: str) -> str:
    return "lib" + Path(src).stem + ".so"


def lib(src: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    so = _libs.get(src)              # every launch asks: no lock once it is loaded
    if so is not None:
        return so
    with _lock:
        if src not in _libs:
            out_dir = build()
            so = ctypes.CDLL(str(out_dir / _so_name(src)))
            for name, args in SIGNATURES[src].items():
                fn = getattr(so, name)
                fn.argtypes = args
                fn.restype = I
            so.stg_error_string.argtypes = [I]
            so.stg_error_string.restype = ctypes.c_char_p
            _libs[src] = so
        return _libs[src]


def check(src: str, err: int) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib(src).stg_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed in {src}: {msg} ({err})")
