"""Hand-written Hopper kernels of the port and their plain PyTorch
versions. Importing a module here costs nothing: the CUDA library is
built and loaded inside the functions that launch the kernels. It does
register the model kernels' PyTorch operators (`sdt::group_norm`,
`sdt::mha`, `sdt::sa_iterations`), which an exported program calls.

Launches are counted in Python, where a wrapper launches; a CUDA graph's
replay runs no Python, so a graph keeps what its capture counted
(`launches_since`) and adds it at every replay (`add_launches`)."""

from . import (attention_kernel, fused_norm, slot_attention_kernel,
               winograd_conv)

KERNEL_MODULES = (fused_norm, attention_kernel, slot_attention_kernel,
                  winograd_conv)
# the reference package: the port's name without "_torch"; each kernel
# module's REPLACES is a file:line inside it
REFERENCE_PACKAGE = __name__.split(".")[0].removesuffix("_torch")


def _counters(mod):
    return (mod.launches, *((mod.route_launches,)
                            if hasattr(mod, "route_launches") else ()))


def reset_launch_counts():
    for mod in KERNEL_MODULES:
        for c in _counters(mod):
            c.update(dict.fromkeys(c, 0))


def launch_counts():
    """{kernel name: launches since the last reset}; the bf16 entry point
    of a kernel that has an f32 one too counts apart, as "<name>_bf16"."""
    counts = {}
    for mod in KERNEL_MODULES:
        for entry, n in mod.launches.items():
            apart = len(mod.launches) > 1 and entry.endswith("_bf16")
            counts[mod.KERNEL_NAME + "_bf16" * apart] = n
    return counts


def launches_by_entry():
    """{C entry point: launches since the last reset}, and the routes of
    an entry that counts them (`fused_norm.route_launches`)."""
    return {entry: n for mod in KERNEL_MODULES for c in _counters(mod)
            for entry, n in c.items()}


def launches_since(before):
    """{C entry point: launches} counted since `before`
    (`launches_by_entry`)."""
    return {entry: n - before[entry]
            for entry, n in launches_by_entry().items()}


def add_launches(delta):
    """Add {C entry point: launches} to the counts."""
    for mod in KERNEL_MODULES:
        for c in _counters(mod):
            for entry in c:
                c[entry] += delta.get(entry, 0)
