"""The port's training start against the JAX package's, on the CPU.

`init_reference_` is held leaf by leaf against the JAX model's own
`model.init` of the tiny flagship-structured config (tests/
torch_parity_helpers.py), by the names `slotdiffusion_tpu_torch.convert`
gives the JAX leaves; and the trainer's EMA follows either of its two
switches, as the JAX trainer's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.models import build_model as build_jax_model
from slotdiffusion_tpu_torch.convert import convert_savi_diffusion
from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
from slotdiffusion_tpu_torch.methods.build import build_method
from slotdiffusion_tpu_torch.models import build_model, init_reference_
from torch_parity_helpers import jax_params_of, tiny_config, video

# Both sides draw DRAWS independent inits and every leaf's std is pooled
# over them. The tiny config's smallest drawn leaves hold 9 values (the
# VQ-VAE's 1x1 quant convs, 3 -> 3 channels), whose std one draw gives only
# to about +-24 % (1/sqrt(2n)); pooled over 16 draws (144 values) each
# side's std is good to about +-6 %, so the +-25 % band is about three
# standard errors of the two sides' difference at the smallest leaf and far
# more at every other.
DRAWS = 16
STD_BAND = 0.25


def _zero_leaves(state):
    """Port names that the JAX model initializes to exactly 0: biases and
    the zero-init convs (unet.py:210, 299, 617)."""
    return {n for n in state if n.endswith("bias") or
            n.endswith(("out_layers.3.weight", "proj_out.weight")) and
            ".unet." in n or n == "dm_decoder.unet.out.2.weight"}


@pytest.fixture(scope="module")
def inits():
    """-> (cfg, [JAX init as port names] * DRAWS, [port init] * DRAWS)."""
    cfg = tiny_config(use_pallas=False)
    jmodel = build_jax_model(jax_params_of(cfg))
    img = jnp.asarray(video())

    def init(key):
        k1, k2, k3 = jax.random.split(key, 3)
        return jmodel.init({"params": k1, "diffusion": k2, "dropout": k3},
                           {"img": img},
                           method=jmodel.compute_losses)["params"]

    batched = jax.jit(jax.vmap(init))(
        jax.random.split(jax.random.PRNGKey(0), DRAWS))
    jax_states = [convert_savi_diffusion(jax.tree_util.tree_map(
        lambda a: np.asarray(a[i]), batched), cfg) for i in range(DRAWS)]
    model = build_model(cfg, device="cpu")
    port_states = []
    for seed in range(DRAWS):
        init_reference_(model, torch.Generator().manual_seed(seed))
        port_states.append({n: p.detach().clone()
                            for n, p in model.named_parameters()})
    return cfg, jax_states, port_states


def test_reference_init_zeros_ones_and_names(inits):
    """The same leaves by name and shape; zero-init convs and every bias
    exactly 0 on both sides; norm scales exactly 1."""
    _, jax_states, port_states = inits
    jax0, port0 = jax_states[0], port_states[0]
    assert set(jax0) == set(port0)
    for n, v in jax0.items():
        assert tuple(v.shape) == tuple(port0[n].shape), n
    zero = _zero_leaves(port0)
    assert "dm_decoder.unet.out.2.weight" in zero
    for n in zero:
        assert not jax0[n].any(), n  # the JAX side agrees these are zero
        assert not port0[n].any(), n
    scales = [n for n, v in port0.items() if v.dim() == 1 and
              n.endswith("weight")]
    assert scales
    for n in scales:
        assert torch.equal(jax0[n], torch.ones_like(jax0[n])), n
        assert torch.equal(port0[n], torch.ones_like(port0[n])), n


def test_reference_init_latents_and_gru_recurrent_blocks(inits):
    """`init_latents` ~ N(0, 1); each [D, D] gate block of the GRU's
    recurrent weight orthogonal to 1e-5."""
    _, _, port_states = inits
    lat = torch.cat([s["savi.init_latents"].flatten() for s in port_states])
    assert 0.8 <= lat.std().item() <= 1.2
    for state in port_states:
        wh = state["savi.slot_attention.gru.weight_hh"].double()
        D = wh.shape[1]
        for g in range(3):
            blk = wh[g * D:(g + 1) * D]
            err = (blk @ blk.T - torch.eye(D, dtype=blk.dtype)).abs().max()
            assert err.item() <= 1e-5, (g, err.item())


def test_reference_init_std_matches_jax_leaf_by_leaf(inits):
    """Every other leaf's std, pooled over DRAWS inits, within STD_BAND of
    the JAX leaf's (see the band's reason above); and means near 0."""
    _, jax_states, port_states = inits
    zero = _zero_leaves(port_states[0])
    checked, bad = 0, []
    for n, v in port_states[0].items():
        if n in zero or v.dim() == 1 or n == "savi.init_latents":
            continue
        j = torch.stack([s[n] for s in jax_states]).double()
        p = torch.stack([s[n] for s in port_states]).double()
        ratio = (p.std() / j.std()).item()
        checked += 1
        if not abs(ratio - 1) <= STD_BAND:
            bad.append((n, ratio))
        assert abs(p.mean().item()) <= 0.25 * j.std().item(), n
    assert checked > 100 and not bad, bad


def test_reference_init_is_seeded():
    cfg = tiny_config(use_pallas=False)
    a, b = (init_reference_(build_model(cfg, device="cpu"),
                            torch.Generator().manual_seed(s))
            for s in (3, 3))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("run_ema,model_ema,want", [
    (False, True, True), (False, False, False), (True, False, True)])
def test_trainer_ema_follows_either_switch(run_ema, model_ema, want):
    """The EMA is on when `params.use_ema` or the decoder's
    `dec_dict["use_ema"]` is set (the JAX trainer's
    training/trainer.py:181-182), off when neither is."""
    cfg = tiny_config(use_pallas=False)
    cfg = cfg.copy(use_ema=run_ema,
                   dec_dict=dict(cfg.dec_dict, use_ema=model_ema))
    model = build_model(cfg, device="cpu")
    data = SyntheticVideoData(cfg, batch_size=2, num_samples=2, seed=0)
    trainer = build_method(model, data, cfg)
    assert (trainer.ema is not None) == want
