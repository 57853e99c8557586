"""The port's slot extraction against the JAX package's on the CPU, on the
trained `checkpoint/savi_ldm_synthetic_long3-res64/ckpt_final` (exported
by `scripts/export_torch_checkpoint.py`): 2 validation videos of 8
frames (`--seq_len 8`, as the repo's chain extracted them) through
`chunked_video_apply` over `encode` with the slots carried between
chunks, as `scripts/extract_slots_torch.py` runs it, against
`scripts/extract_slots.py`'s `encode_video` (the JAX
`chunked_video_apply` over its jitted `encode_chunk`), f32 on both sides
and the JAX matmuls at "highest" precision (tests/conftest.py).

The committed extraction pickle was made on the TPU, whose default f32
matmul runs at bf16 precision. Its distance from both CPU extractions is
printed (`-s`); the test holds that the two f32 extractions agree with
each other far more closely than either does with the pickle, so the
pickle's difference is the TPU's precision alone.
"""

import importlib.util
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.methods.inference import \
    chunked_video_apply as jax_chunked
from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu.training.checkpoint import load_model_params
from slotdiffusion_tpu.utils import load_params
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.data import build_dataset
from slotdiffusion_tpu_torch.methods.inference import chunked_video_apply
from slotdiffusion_tpu_torch.models import build_model
from slotdiffusion_tpu_torch.training.checkpoint import load_model_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, VIDEOS = 8, 2
# f32 on both sides through 8 frames of carried slots (2 iterations each
# and the predictor): the trained SAViDiffusion's encode agrees to ~1e-5
# on one chunk (tests/test_torch_trained.py), and the carry adds to it
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_extraction_matches_jax_and_the_pickle_differs_by_precision(
        tmp_path):
    export = _script("export_torch_checkpoint")
    jcfg, ckpt, _ = (os.path.join(REPO, p)
                     for p in export.DEFAULTS["savi_ldm_long3"])
    pt = str(tmp_path / "model.pt")
    export.export(jcfg, ckpt, pt)
    params = configs.SAViLDMSyntheticLong3_64()
    params.n_sample_frames = FRAMES
    model = build_model(params, device="cpu")
    load_model_weights(model, pt)
    model.eval()
    val = build_dataset(params)[1]
    videos = np.stack([val[i]["img"] for i in range(VIDEOS)])
    assert videos.shape == (VIDEOS, FRAMES, 64, 64, 3)
    with torch.inference_mode():
        got = chunked_video_apply(
            lambda x, prev: model({"img": x}, prev_slots=prev),
            torch.from_numpy(videos), FRAMES, keys=("slots",))[
            "slots"].numpy()

    jparams = load_params(jcfg)
    jparams.n_sample_frames = FRAMES
    jmodel = build_jax_model(jparams)
    variables = load_model_params(jmodel, ckpt, jparams)

    @jax.jit
    def encode_chunk(img, prev_slots):  # scripts/extract_slots.py
        return jmodel.apply(variables, {"img": img}, prev_slots=prev_slots,
                            train=False, testing=True,
                            rngs={"diffusion": jax.random.PRNGKey(0)})

    want = np.asarray(jax_chunked(encode_chunk, jnp.asarray(videos), FRAMES,
                                  keys=("slots",))["slots"])
    assert got.shape == want.shape == (VIDEOS, FRAMES, 6, 64)
    np.testing.assert_allclose(got, want, **TOL)

    with open(os.path.join(REPO, "checkpoint",
                           "savi_ldm_synthetic_long3-res64",
                           "slots_synthetic.pkl"), "rb") as f:
        tpu_val = pickle.load(f)["val"]
    tpu = np.stack([tpu_val[str(i)] for i in range(VIDEOS)])
    scale = np.abs(want).max()
    d_port = np.abs(got - want).max() / scale
    d_tpu_jax = np.abs(tpu - want).max() / scale
    d_tpu_port = np.abs(tpu - got).max() / scale
    print(f"\nlong3 extraction, {VIDEOS} videos x {FRAMES} frames, of the "
          f"slots' scale {scale:.3f}: port vs JAX (CPU, f32) {d_port:.2e}; "
          f"the TPU pickle vs JAX {d_tpu_jax:.2e}, vs the port "
          f"{d_tpu_port:.2e}")
    assert d_tpu_jax > 10 * d_port and d_tpu_port > 10 * d_port
