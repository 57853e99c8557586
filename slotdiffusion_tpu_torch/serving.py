"""Serving surfaces of the port: live callables, one CUDA graph per
surface and input shape, and exported artifacts (mirrors the JAX
package's serving.py:35-137), for the video model (SAViDiffusion) and the
image model (SADiffusion), and `encode` of STEVE (video) and SLATE
(image), whose masks stay at the visual resolution as their JAX forwards
return them; SA and SAVi, whose testing forward carries no masks, have
no `encode` surface (`build_serving_fn` raises ValueError, where the
JAX package's fails on `out["masks"]`):

- ``encode``  img [B, T, H, W, 3] -> (slots [B, T, S, D],
  masks [B, T, S, H, W]); an image [B, H, W, 3] -> (slots [B, S, D],
  masks [B, S, H, W]);
- ``sample``  (seed, slots [B, T, S, D]) -> imgs [B, T, H, W, 3]: the
  DPM-Solver++ chain over the B*T frames, then VQ decode (an LDM); a
  pixel-space decoder samples the images themselves, with its dynamic
  thresholding as the x0 correction and no decode, as the JAX surface
  runs `generate_imgs(use_dpm=True)` and decodes only an LDM's; image
  slots [B, S, D] -> imgs [B, H, W, 3];
- ``denoise`` (x_t [B*T, h, w, C], t [B*T], slots) -> the UNet output.

Each surface is a module that holds only the submodules it runs (SAVi,
or the image model's encoder, slot attention and `init_latents`, for
`encode`, the UNet for `denoise`, the LDM for `sample`). On a CUDA device
`build_serving_fn` replays it from one `torch.cuda.CUDAGraph` per input
shapes and dtypes (`CudaGraphed`), the port's counterpart of the JAX
package's one compiled program; on the CPU, or with `graphed=False`, it
runs eagerly. `sample` draws x_T from `torch.Generator(device)
.manual_seed(seed)` outside the graph (`draw_noise`) and runs the rest
(every DPM coefficient is a host float, so the chain has no host sync)
inside it, so one seed gives one output on every path.

Outputs keep the JAX package's dtypes: slots in the model's compute dtype
(bf16 under `use_bf16`), masks, images and the UNet output in f32.

Artifacts (`save_artifact` / `load_artifact`): a JSON header line (magic,
surface, the devices exported for, the device traced on, the callable's
and the program's argument shapes and dtypes, the caller's metadata, the
device and byte length of each exported program), then the
`torch.export.save` bytes of each program. One trace on the host's own
device gives the programs of every device `devices` names (the JAX
exporter's `platforms`, serving.py:35-60): another device's copy has its
graph retargeted (`retarget`: device arguments, `.to` targets, tensor
metadata), while its weights and constants are stored in host memory
and moved to the device at load (`torch.export.passes.
move_to_device_pass`). So a host without a card exports for the card;
the kernels are `sdt::` operators with a CPU implementation and a CUDA
kernel each, so the CPU trace holds the nodes a card trace holds, and
nothing the model decides from the tracing device reaches the graph
(the kernels' launch plans and GN's two-pass split are taken at run
time, inside the CUDA implementations). A header of one `device` (an
artifact of one device, written before `devices`) is read as it was.

`encode` and `denoise` are one program each. `sample`'s program
(x_T, slots) -> imgs is three: the UNet step, the VQ quantize (the
sampler's x0 correction) and the VQ decode (two for a pixel-space
decoder: the UNet step and the dynamic thresholding), with the sampler's
schedule in the header; the loaded callable runs the port's DPM-Solver++
(`ops.dpm_solver.sample_denoiser`, the code the live `sample` runs) over
them, and on the card replays the whole chain from one CUDA graph. One
exported program of the unrolled chain would hold the UNet's graph 20
times, and `torch.export`'s export, save and load walk every node in
Python. So a `sample` artifact is not self-contained: its output depends
on the sampler code of the port that loads it. The header names that code
(`ops.dpm_solver.SAMPLER`) and `load_artifact` refuses an artifact that
names another. Loading needs `torch` and this package's `ops` (which
register the `sdt::` operators the programs call and hold the sampler);
no model class and no config. The loaded callable replays CUDA graphs
when the artifact is for the card, and runs eagerly on the CPU.
"""

import io
import json
import math
import os

import torch
from torch import nn

import numpy as np

from . import ops
from .models import is_video
from .models.diffusion import denoise_nhwc
from .models.slot_diffusion import encode_image, encode_video
from .ops.dpm_solver import SAMPLER, sample_denoiser

MAGIC = "slotdiffusion-tpu-torch-export-v1"
SURFACES = ("encode", "sample", "denoise")
# the models whose testing forward carries no masks: no `encode` surface
NO_MASKS = ("SA", "SAVi")
# warm-up calls on a side stream before a capture: the allocator's blocks,
# cuBLAS's and cuDNN's handles and workspaces come into being outside the
# graph
WARMUP = 2


def _fold(slots):
    return slots.reshape(-1, *slots.shape[-2:]) if slots.dim() == 4 \
        else slots


def draw_noise(seed, shape, device):
    """x_T of `sample`: `torch.randn` from `torch.Generator(device)
    .manual_seed(seed)`, as `CondDDPM.sample_dpm` draws it."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=gen, device=device)


class _Encode(nn.Module):
    def __init__(self, model):
        super().__init__()
        name = type(model).__name__
        if name in NO_MASKS:
            raise ValueError(
                f"{name} has no encode surface: its testing forward returns "
                "slots only, no masks (the JAX package's build_serving_fn "
                "reads out['masks'] and refuses it too)")
        self.resolution = tuple(model.resolution)
        # the diffusion models serve masks at the input's resolution,
        # STEVE and SLATE at the visual one, as their JAX forwards return
        self.at_visual = not getattr(model, "upsample_masks", True)
        self.video = is_video(name)
        if self.video:
            self.savi = model.savi
        else:
            self.encoder = model.encoder
            self.slot_attention = model.slot_attention
            self.init_latents = model.init_latents
            self.compute_dtype = model.compute_dtype

    def forward(self, img):
        if self.video:
            return encode_video(self.savi, self.resolution, img,
                                train=self.at_visual)
        return encode_image(self, self.resolution, img,
                            train=self.at_visual)


class _Denoise(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.unet = model.dm_decoder.unet

    def forward(self, x, t, slots):
        return denoise_nhwc(self.unet, x, t, _fold(slots))


class _Call(nn.Module):
    """`fn(*args)` as a module holding `owner` (the parameters it reads)."""

    def __init__(self, owner, fn):
        super().__init__()
        self.owner, self.fn = owner, fn

    def forward(self, *args):
        return self.fn(*args)


class _Sample(nn.Module):
    """(x_T [B*T, h, w, C], slots) -> imgs: DPM-Solver++ from x_T over the
    UNet step `denoise` (x, t, cond [B*T, S, D]) with `quantize` as the
    x0 correction, then `decode` (None: the samples are the images);
    video slots [B, T, S, D] give [B, T, H, W, 3]. `sampler`: the
    schedule's betas, steps, order and model type, and `code`, the
    `ops.dpm_solver.SAMPLER` it was made for. The parts are the
    decoder's own modules (an LDM's VQ quantize and decode, a pixel
    decoder's dynamic thresholding), or their exported programs."""

    def __init__(self, denoise, quantize, decode, sampler):
        super().__init__()
        self.denoise, self.quantize, self.decode = denoise, quantize, decode
        self.sampler = dict(sampler)
        self.betas = np.asarray(sampler["betas"], np.float64)

    def forward(self, x_T, slots):
        s = self.sampler
        x = sample_denoiser(
            self.denoise, self.betas, x_T, _fold(slots), steps=s["steps"],
            order=s["order"], model_type=s["model_type"],
            correcting_x0_fn=self.quantize)
        if self.decode is not None:
            x = self.decode(x)
        if slots.dim() == 4:
            x = x.reshape(*slots.shape[:2], *x.shape[1:])
        return x

    @classmethod
    def of(cls, model):
        dm = model.dm_decoder
        latent = (*dm.resolution, dm.channels)
        sampler = {"betas": dm.betas.tolist(), "steps": dm.dpm_steps,
                   "order": 3, "model_type": dm.pred_target,
                   "latent": list(latent), "code": SAMPLER}
        if not hasattr(dm, "vae"):  # pixels: no decode
            return cls(_Denoise(model), _Call(nn.Module(),
                                              dm.dpm_correct_x0),
                       None, sampler)
        return cls(_Denoise(model), _Call(dm.vae, dm.dpm_correct_x0),
                   _Call(dm.vae, dm.decode_latent), sampler)

    def noise_shape(self, slots_shape):
        return (math.prod(slots_shape[:-2]), *self.sampler["latent"])

    def parts(self, x_T, slots):
        """{part: (module, its arguments)} at a request's shapes."""
        B = x_T.shape[0]
        t = torch.zeros((B,), dtype=torch.float32, device=x_T.device)
        parts = {"denoise": (self.denoise, (x_T, t, _fold(slots))),
                 "quantize": (self.quantize, (x_T,))}
        if self.decode is not None:
            parts["decode"] = (self.decode, (x_T,))
        return parts


def _weights_key(module):
    """The addresses of `module`'s parameters and buffers: a graph reads
    them there, so it holds while this key does (an in-place copy, as the
    EMA swap and `load_state_dict` make, keeps it)."""
    return tuple(t.data_ptr() for t in (*module.parameters(),
                                        *module.buffers()))


class CudaGraphed:
    """`fn(*tensors)` replayed from one CUDA graph per input shapes and
    dtypes. A capture runs `fn` WARMUP times on a side stream, then
    captures one call on static input buffers; a call copies its inputs
    into them, replays, and returns copies of the static outputs. The
    kernels' launch counts that the capture recorded are added at every
    replay (`ops.add_launches`). When the storage of a parameter or buffer
    of `module` moves, every graph is dropped and captured again at its
    next call. A capture that fails raises."""

    def __init__(self, fn, module):
        self.fn, self.module = fn, module
        self.graphs = {}
        self.weights = _weights_key(module)

    def drop_if_weights_moved(self):
        key = _weights_key(self.module)
        if key != self.weights:
            self.graphs.clear()
            self.weights = key

    def _capture(self, args):
        static_in = [a.clone() for a in args]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.fn(*static_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = ops.launches_by_entry()
        with torch.cuda.graph(graph):
            out = self.fn(*static_in)
        launched = ops.launches_since(before)
        # a capture records the launches; it runs none of them
        ops.add_launches({k: -n for k, n in launched.items()})
        return static_in, out, graph, launched

    def __call__(self, *args):
        self.drop_if_weights_moved()
        sig = tuple((tuple(a.shape), a.dtype) for a in args)
        if sig not in self.graphs:
            self.graphs[sig] = self._capture(args)
        static_in, out, graph, launched = self.graphs[sig]
        for s, a in zip(static_in, args):
            s.copy_(a)
        graph.replay()
        ops.add_launches(launched)
        if isinstance(out, tuple):
            return tuple(o.clone() for o in out)
        return out.clone()


class Surface:
    """One serving surface: `__call__` takes the request's arguments
    (tensors or numpy arrays; `sample`'s seed an integer), moves them to
    `device`, makes the program's arguments (`program_args`: `sample`
    draws x_T) and runs `program` under `torch.inference_mode`.
    `module` is what `export_fn` exports; `program` runs it, eagerly or
    from CUDA graphs."""

    def __init__(self, what, module, device, graphed, noise_shape=None):
        if what not in SURFACES:
            raise ValueError(f"unknown serving surface {what!r}")
        self.what, self.module = what, module
        self.device = torch.device(device)
        if graphed and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{self.device}")
        self.program = CudaGraphed(module, module) if graphed else module
        self.noise_shape = noise_shape

    def program_args(self, *args):
        if self.what == "sample":
            seed, slots = int(args[0]), torch.as_tensor(args[1])
            return (draw_noise(seed, self.noise_shape(tuple(slots.shape)),
                               self.device), slots.to(self.device))
        return tuple(torch.as_tensor(a).to(self.device) for a in args)

    def __call__(self, *args):
        with torch.inference_mode():
            return self.program(*self.program_args(*args))


def data_shape(params, batch):
    """A request's input shape for the config `params`: `batch` videos
    [B, T, H, W, 3] of a video model, `batch` images [B, H, W, 3] of an
    image model (the JAX scripts/export_model.py:62-66)."""
    shape = (batch, *params.resolution, 3)
    if is_video(params.model):
        return (batch, params.n_sample_frames, *shape[1:])
    return shape


def example_args(model, what, data_shape):
    """Zero arguments of one `what` request on video of `data_shape`
    [B, T, H, W, 3], or images [B, H, W, 3] (the JAX
    `build_serving_fn`'s): encode (img,); sample
    (seed, slots); denoise (x_t, t, slots), t f32 (the sampler's model
    time is fractional). Slots are f32, as a client sends them."""
    f32 = torch.float32
    if what == "encode":
        return (torch.zeros(data_shape, dtype=f32),)
    slots = torch.zeros((*data_shape[:-3], model.num_slots,
                         model.slot_size), dtype=f32)
    if what == "sample":
        return (torch.tensor(0, dtype=torch.int32), slots)
    dm = model.dm_decoder
    B = math.prod(data_shape[:-3])
    return (torch.zeros((B, *dm.resolution, dm.channels), dtype=f32),
            torch.zeros((B,), dtype=f32), slots)


def build_serving_fn(model, what, data_shape=None, graphed=None):
    """-> a `Surface` for `what` of a built SAViDiffusion or SADiffusion
    `model` (`encode` also of STEVE and SLATE; SA and SAVi have none:
    ValueError), on the model's device; with `data_shape` (the video shape
    [B, T, H, W, 3], or the images' [B, H, W, 3]), -> (surface,
    `example_args`). `graphed` (default: on a CUDA device)
    replays CUDA graphs; `graphed=False` runs eagerly."""
    device = next(model.parameters()).device
    graphed = device.type == "cuda" if graphed is None else graphed
    module = {"encode": _Encode, "sample": _Sample.of,
              "denoise": _Denoise}.get(what)
    if module is None:
        raise ValueError(f"unknown serving surface {what!r}")
    module = module(model)
    fn = Surface(what, module, device, graphed,
                 getattr(module, "noise_shape", None))
    if data_shape is None:
        return fn
    return fn, example_args(model, what, data_shape)


def _spec(t):
    return {"shape": list(t.shape),
            "dtype": str(t.dtype).removeprefix("torch.")}


def export_fn(fn, example):
    """`torch.export` of the surface `fn` at the program arguments of the
    request `example` -> {program name: ExportedProgram}: "main" for
    `encode` and `denoise`, the three parts of `_Sample` for `sample`.
    The kernels are one node each (their `sdt::` operators)."""
    args = fn.program_args(*example)
    parts = fn.module.parts(*args) if fn.what == "sample" \
        else {"main": (fn.module, args)}
    with torch.no_grad():
        return {name: torch.export.export(mod, tuple(a))
                for name, (mod, a) in parts.items()}


def retarget(program, device):
    """`program` (an ExportedProgram, changed in place) with its graph made
    for `device`: the `device` arguments of its nodes, the targets of
    `aten.to.device` and every tensor's metadata, as
    `torch.export.passes.move_to_device_pass` moves them; its weights and
    constants stay where they are (`load_artifact` moves them), so no
    tensor is made on `device` here."""
    import torch.utils._pytree as pytree
    from torch._subclasses.fake_tensor import FakeTensor
    device = str(torch.device(device))
    for m in program.graph_module.modules():
        if not isinstance(m, torch.fx.GraphModule):
            continue
        for node in m.graph.nodes:
            if "device" in node.kwargs:
                node.kwargs = dict(node.kwargs, device=device)
            if node.op == "call_function" and \
                    node.target is torch.ops.aten.to.device:
                node.args = (node.args[0], device, *node.args[2:])
            if "val" in node.meta:
                node.meta["val"] = pytree.tree_map_only(
                    FakeTensor, lambda v: _fake_on(v, device),
                    node.meta["val"])
    return program


def _fake_on(v, device):
    """The fake tensor `v` on `device`, made without touching the device
    (a CPU-only build cannot initialise CUDA, which `v.to` would)."""
    from torch._subclasses.fake_tensor import FakeTensor
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    meta = torch.empty_strided(v.shape, v.stride(), dtype=v.dtype,
                               device="meta")
    return FakeTensor(v.fake_mode, meta, device)


def save_artifact(path, fn, example, meta=None, devices=None):
    """Export the surface `fn` (traced once, on its own device) and write
    the artifact file with one program set per device of `devices`
    (default: `fn`'s device); -> the header dict."""
    devices = [torch.device(d).type for d in (devices or [fn.device])]
    blobs = []
    for name, program in export_fn(fn, example).items():
        buf = io.BytesIO()
        torch.export.save(program, buf)
        own = buf.getvalue()
        for dev in devices:
            if dev == fn.device.type:
                blobs.append((dev, name, own))
                continue
            copy = retarget(torch.export.load(io.BytesIO(own)), dev)
            out = io.BytesIO()
            torch.export.save(copy, out)
            blobs.append((dev, name, out.getvalue()))
    # `device`: the default load device, as a one-device header names it
    header = {"magic": MAGIC, "surface": fn.what, "device": devices[0],
              "devices": devices, "traced_on": fn.device.type,
              "meta": meta or {},
              "args": [_spec(torch.as_tensor(a)) for a in example],
              "program_args": [_spec(a) for a in fn.program_args(*example)],
              "programs": [{"name": n, "device": d, "bytes": len(b)}
                           for d, n, b in blobs]}
    if fn.what == "sample":
        header["sampler"] = fn.module.sampler
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write((json.dumps(header) + "\n").encode())
        for _, _, b in blobs:
            f.write(b)
    return header


def artifact_devices(header):
    """The device types an artifact header holds programs for (an old
    header: its one `device`)."""
    return header.get("devices") or [header["device"]]


def load_artifact(path, device=None):
    """-> (callable, header). The callable takes the request's arguments
    as the live surface does (`sample`: (seed, slots)) and runs the
    program of `device` (default: the header's `device`, the first it was
    exported for), replayed
    from CUDA graphs on a CUDA device. Raises ValueError for a file that
    is not an artifact, for a device the artifact lacks, or for a
    `sample` artifact made for another sampler, and RuntimeError when the
    device is not present."""
    with open(path, "rb") as f:
        try:
            header = json.loads(f.readline().decode())
        except (UnicodeDecodeError, ValueError):
            header = None
        if not isinstance(header, dict) or header.get("magic") != MAGIC:
            raise ValueError(f"{path} is not a slotdiffusion_tpu_torch "
                             "export")
        devices = artifact_devices(header)
        blobs = {}
        for p in header["programs"]:
            blobs[(p.get("device", devices[0]), p["name"])] = f.read(
                p["bytes"])
    dev = torch.device(device if device is not None else header["device"])
    lacks = ValueError(f"{path} was exported for {', '.join(devices)}, not "
                       f"{dev.type}: export it for {dev.type}")
    if device is not None and dev.type not in devices:
        raise lacks
    if header["surface"] == "sample" and \
            header["sampler"].get("code") != SAMPLER:
        raise ValueError(f"{path} was made for the sampler "
                         f"{header['sampler'].get('code')!r}, and this port "
                         f"samples with {SAMPLER!r}: export it again")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for a CUDA card, and "
                           "there is none here")
    if dev.type not in devices:
        raise lacks
    from torch.export.passes import move_to_device_pass
    programs = {name: move_to_device_pass(
        torch.export.load(io.BytesIO(b)), dev.type).module()
        for (d, name), b in blobs.items() if d == dev.type}
    if header["surface"] == "sample":
        module = _Sample(programs["denoise"], programs["quantize"],
                         programs.get("decode"), header["sampler"])
    else:
        module = programs["main"]
    fn = Surface(header["surface"], module, dev, dev.type == "cuda",
                 getattr(module, "noise_shape", None))
    return fn, header
