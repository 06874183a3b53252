"""The NVIDIA H100's published peaks (SXM part, dense rates, NVIDIA's data
sheet) and the least time a piece of work can take on it.

Every share the benchmark reports (`mfu.*`, `kernels_roofline.*`) divides
by these, whatever implements the work, so no share can pass 100%:

  - products of float32 operands count once, at the TF32 tensor-core rate,
    the chip's fastest dense product of float32 inputs (a split-TF32
    kernel that spends three tensor-core products on one float32 product
    is still held to one);
  - products of bfloat16 or float16 operands at the bfloat16 rate;
  - elementwise operations at the FP32 pipes' rate;
  - bytes at HBM3's rate, each input read once and each output written
    once.

The rates assume the card's full 700 W power limit; run.py prints the
card's name and limit beside them.
"""

PEAK_TF32 = 495e12     # float32 products, FLOP/s
PEAK_BF16 = 989e12     # bfloat16 / float16 products, FLOP/s
PEAK_FP32 = 67e12      # elementwise, FLOP/s
PEAK_BYTES = 3.35e12   # HBM3, bytes/s


def product_peak(itemsize: int) -> float:
    """The product rate for operands of `itemsize` bytes."""
    return PEAK_BF16 if itemsize == 2 else PEAK_TF32


def least_seconds(products: float, elementwise: float, nbytes: float,
                  itemsize: int) -> float:
    """The least time the card can take for this work: the products, the
    elementwise operations and the bytes each at their own peak, which run
    side by side, so the largest of the three bounds it."""
    return max(products / product_peak(itemsize), elementwise / PEAK_FP32,
               nbytes / PEAK_BYTES)
