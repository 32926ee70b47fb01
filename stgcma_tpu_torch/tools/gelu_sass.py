"""Count the instructions of one erf-GELU on sm_90a, the term of K7's bound that
its hidden's activation sets (`bench_parts.py` GELU_INSTRUCTIONS).

    python3 stgcma_tpu_torch/tools/gelu_sass.py

Compiles two one-line kernels with nvcc for sm_90a, y[i] = gelu(x[i]) with
csrc/ffn.cu's own `erf_gelu` (read from the source) and y[i] = x[i], and
prints the instruction count of each kernel's SASS (cuobjdump) and their
difference, with the special-function (MUFU) instructions among them. Needs
nvcc and cuobjdump (the CUDA toolkit); builds under build/gelu_sass/ at the
root of the checkout.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from stgcma_tpu_torch.ops.cuda_lib import _nvcc  # noqa: E402

FFN_CU = Path(__file__).resolve().parents[1] / "csrc" / "ffn.cu"
PROBES = r"""
extern "C" __global__ void gelu(const float* __restrict__ x, float* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = erf_gelu(x[i]);
}
extern "C" __global__ void copy(const float* __restrict__ x, float* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = x[i];
}
"""


def sass_counts(cubin: Path) -> dict:
    """{kernel: (instructions, MUFU instructions)} of a cubin's SASS, the
    trailing BRA-to-self and NOPs of alignment left out."""
    nvcc = Path(_nvcc())
    dump = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+([^;]+);", line)
        if name is None or not m:
            continue
        op = m.group(1).split()[0] if not m.group(1).startswith("@") else m.group(1).split()[1]
        if op in ("NOP", "BRA"):
            continue
        counts[name][0] += 1
        counts[name][1] += op.startswith("MUFU")
    return {k: tuple(v) for k, v in counts.items()}


def main() -> int:
    out_dir = Path(__file__).resolve().parents[2] / "build" / "gelu_sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, cubin = out_dir / "gelu.cu", out_dir / "gelu.cubin"
    gelu_fn = re.search(r"__device__ __forceinline__ float erf_gelu\(float v\) \{.*?\n\}\n",
                        FFN_CU.read_text(), re.S).group(0)
    src.write_text("#include <math.h>\n" + gelu_fn + PROBES)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-cubin",
                    "-o", str(cubin), str(src)], check=True)
    counts = sass_counts(cubin)
    gelu, copy = counts["gelu"], counts["copy"]
    print(json.dumps({"gelu_kernel": gelu[0], "copy_kernel": copy[0],
                      "gelu_instructions": gelu[0] - copy[0], "gelu_mufu": gelu[1] - copy[1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
