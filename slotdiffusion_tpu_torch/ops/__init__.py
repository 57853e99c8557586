"""Hand-written Hopper kernels of the port and their plain PyTorch
versions. Importing a module here costs nothing: the CUDA library is
built and loaded inside the functions that launch the kernels."""

from . import (attention_kernel, fused_norm, slot_attention_kernel,
               winograd_conv)

KERNEL_MODULES = (fused_norm, attention_kernel, slot_attention_kernel,
                  winograd_conv)
# the reference package: the port's name without "_torch"; each kernel
# module's REPLACES is a file:line inside it
REFERENCE_PACKAGE = __name__.split(".")[0].removesuffix("_torch")


def reset_launch_counts():
    for mod in KERNEL_MODULES:
        mod.launches = 0


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {mod.KERNEL_NAME: mod.launches for mod in KERNEL_MODULES}
