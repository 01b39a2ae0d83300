"""K1, family D's conv1 (``csrc/tfold_conv1.cu``): Conv3d 3 -> 16,
kernel 3, stride (1, 2, 2), padding 1, on (B, C, T, H, W) clips.

Operations: two per multiply-add of every output.  Bytes: the input read
once, the output written once, the weights read once.  The bound is the
larger of operations over the peak of the dtype and bytes over the HBM
rate.
"""

from portbench.harness import PEAK_BYTES_S, PEAK_FLOPS

NAME = "tfold_conv1_"  # the kernels' names: tfold_conv1_{f32,bf16}_kernel
COUNTER = "launches.tfold_conv1"


def bound_s(b: int, t: int, h: int, w: int, dtype: str, cin: int = 3,
            cout: int = 16) -> float:
    ho, wo = (h + 1) // 2, (w + 1) // 2
    outputs = b * cout * t * ho * wo
    ops = 2 * outputs * cin * 27
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (b * cin * t * h * w + outputs + cout * cin * 27) * size
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S)
