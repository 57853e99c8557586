"""The (data, model) device mesh of a multi-process run and the batch
utilities around it (the counterpart of the JAX package's
parallel/mesh.py:25-109).

- `make_mesh(data, model)`: a `DeviceMesh` over every process of the
  group, dims ("data", "model"), the card's or the CPU's by the group's
  backend; `get_mesh` / `set_mesh` hold the process-global one (None in
  a single-process run).
- `shard_batch(batch, index, count)`: this rank's contiguous block of a
  global batch (the JAX loader's block, not a stride), so the blocks in
  rank order are the single-process batch.
- `global_batch_draws(generator, index, count)`: inside the block every
  draw from `generator` whose leading dimension is the local batch is
  drawn for the global batch and this rank's rows are kept, so each rank
  uses exactly the draws a single process makes for its block, and every
  rank's generator state stays the same. A draw that the whole batch
  shares (`same_noise`) says so with `shared_draws()` and is made as it
  is.
- `prefetch_to_device(iterator, device)`: pinned host memory, a
  non-blocking copy one batch ahead, on a side stream on the card.
"""

import collections
import contextlib

import numpy as np
import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

_MESH = None
_SHARED = [False]  # inside `shared_draws()`

# torch functions that draw from a `generator=`: those taking a size
# (factories), and the in-place ones filling their first argument
_FACTORIES = {torch.randn, torch.rand, torch.randint}
_IN_PLACE = {torch.Tensor.exponential_, torch.Tensor.normal_,
             torch.Tensor.uniform_, torch.Tensor.bernoulli_}


def make_mesh(data=None, model=1, device=None):
    """A ("data", "model") `DeviceMesh` over the initialised process
    group; `data` defaults to world / model, `device` ("cuda" or "cpu")
    to the card's under NCCL, else the CPU's (gloo ranks that hold CUDA
    tensors, several on one card, pass "cuda")."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} processes")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))


def get_mesh():
    """The process-global mesh: the one `set_mesh` gave, else one made
    on first use when several processes run, else None."""
    global _MESH
    if _MESH is None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        _MESH = make_mesh()
    return _MESH


def set_mesh(mesh):
    global _MESH
    _MESH = mesh


def data_coords(mesh):
    """(this rank's index on the data dim, the data dim's size); (0, 1)
    without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh["data"].get_local_rank(), mesh["data"].size()


def block(x, index, count):
    """Rows `index` of `count` contiguous blocks of `x`'s leading dim (as
    `np.array_split`)."""
    if torch.is_tensor(x):
        return x.tensor_split(count)[index]
    return np.array_split(x, count)[index]


def shard_batch(batch, index, count):
    """This rank's block of every entry of the global `batch` (a dict of
    tensors or arrays)."""
    return {k: block(v, index, count) if hasattr(v, "shape") and
            len(v.shape) else v for k, v in batch.items()}


@contextlib.contextmanager
def shared_draws():
    """Draws made inside are shared by the whole batch (one noise sample
    repeated over it): `global_batch_draws` makes them as they are, so
    every rank holds the single process's draw."""
    before, _SHARED[0] = _SHARED[0], True
    try:
        yield
    finally:
        _SHARED[0] = before


class global_batch_draws(TorchFunctionMode):
    """Within the block, a draw from `generator` with leading dimension n
    (the size of a factory, the filled tensor of an in-place draw) is
    made at n * count and rows [index * n, (index + 1) * n) are kept.
    Draws of a 0-dim shape, inside `shared_draws()`, and from other
    generators, run as they are. With count 1 nothing changes."""

    def __init__(self, generator, index, count):
        super().__init__()
        self.generator, self.index, self.count = generator, index, count

    def _rows(self, full, n):
        return full.narrow(0, self.index * n, n)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if self.count == 1 or _SHARED[0] or \
                kwargs.get("generator") is not self.generator:
            return func(*args, **kwargs)
        if func in _FACTORIES:
            # randint(high, size) / randint(low, high, size); randn(size)
            # or randn(*size)
            lead = ()
            if "size" in kwargs:
                size = kwargs.pop("size")
                lead = args
            elif func is torch.randint:
                lead, size = args[:-1], args[-1]
            else:
                size = args[0] if len(args) == 1 and not isinstance(
                    args[0], int) else args
            size = tuple(size)
            if not size:
                return func(*lead, size, **kwargs)
            out = func(*lead, (size[0] * self.count, *size[1:]), **kwargs)
            return self._rows(out, size[0]).contiguous()
        if func in _IN_PLACE and args and torch.is_tensor(args[0]) and \
                args[0].dim():
            x = args[0]
            full = x.new_empty((x.shape[0] * self.count, *x.shape[1:]))
            func(full, *args[1:], **kwargs)
            with torch.no_grad():
                x.copy_(self._rows(full, x.shape[0]))
            return x
        return func(*args, **kwargs)


def prefetch_to_device(iterator, device, size=1):
    """Yield the dict batches of `iterator` with their tensors on
    `device`: on the card each is pinned and copied non-blocking on a
    side stream `size` batches ahead of the consumer, whose stream waits
    for the copy before the batch is handed over; elsewhere each is
    moved as it comes."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: v.to(device) if torch.is_tensor(v) else v
                   for k, v in batch.items()}
        return
    side = torch.cuda.Stream(device)
    staged = collections.deque()

    def stage(batch):
        with torch.cuda.stream(side):
            return {k: v.pin_memory().to(device, non_blocking=True)
                    if torch.is_tensor(v) else v for k, v in batch.items()}

    def hand_over():
        batch = staged.popleft()
        current = torch.cuda.current_stream(device)
        current.wait_stream(side)
        for v in batch.values():
            if torch.is_tensor(v):
                v.record_stream(current)
        return batch

    for batch in iterator:
        staged.append(stage(batch))
        if len(staged) > size:
            yield hand_over()
    while staged:
        yield hand_over()
