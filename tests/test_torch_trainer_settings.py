"""The JAX trainer's settings in the port's Trainer, on the CPU: the
config keys every port config carries against its JAX config file, and
what `max_steps`, `san_check_val_step`, `save_epoch_end`,
`profile_dir`/`profile_steps`, `use_wandb` and `async_ckpt` do, held
against the JAX trainer's run of the same settings on a tiny VQ-VAE (the
val batches each validation takes, the checkpoints written) where the
JAX package does the same thing, and on the port alone where it writes
another format (a torch.profiler trace, a torch.save file).
"""

import json
import os
import sys
import types

import jax
import pytest
import torch

from slotdiffusion_tpu.utils import load_params
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.data.loader import DataModule
from slotdiffusion_tpu_torch.data.synthetic import SyntheticImageDataset
from slotdiffusion_tpu_torch.methods.build import build_method
from slotdiffusion_tpu_torch.models import build_model
from slotdiffusion_tpu_torch.training.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each port config's JAX config file (under configs/)
JAX_CONFIGS = {
    "SAViLDMMoviE128": "video_based/savi_ldm/savi_ldm_movie_params-res128.py",
    "SAViLDMMoviFile64": "savi_ldm_movi_file-res64.py",
    "SAViLDMMoviD128": "video_based/savi_ldm/savi_ldm_movid_params-res128.py",
    "SAViLDMMoviSolid128":
        "video_based/savi_ldm/savi_ldm_movisolid_params-res128.py",
    "SAViLDMMoviTex128":
        "video_based/savi_ldm/savi_ldm_movitex_params-res128.py",
    "VQVAEMoviE128": "video_based/savi_ldm/vqvae_movie_params-res128.py",
    "VQVAEMoviD128": "video_based/savi_ldm/vqvae_movid_params-res128.py",
    "VQVAEMoviSolid128":
        "video_based/savi_ldm/vqvae_movisolid_params-res128.py",
    "VQVAEMoviTex128": "video_based/savi_ldm/vqvae_movitex_params-res128.py",
    "VQVAESynthetic64": "vqvae_synthetic_params-res64.py",
    "VQVAESyntheticLPIPS64": "vqvae_synthetic_lpips-res64.py",
    "SACLEVRTex128": "img_based/sa/sa_clevrtex_params-res128.py",
    "SACelebA128": "img_based/sa/sa_celeba_params-res128.py",
    "SALDMCLEVRTex128": "img_based/sa_ldm/sa_ldm_clevrtex_params-res128.py",
    "SALDMCelebA128": "img_based/sa_ldm/sa_ldm_celeba_params-res128.py",
    "VQVAECLEVRTex128": "img_based/sa_ldm/vqvae_clevrtex_params-res128.py",
    "VQVAECelebA128": "img_based/sa_ldm/vqvae_celeba_params-res128.py",
    "SASyntheticLong64": "sa_synthetic_long-res64.py",
    "SALDMSyntheticLong64": "sa_ldm_synthetic_long-res64.py",
    "SAViMoviE128": "video_based/savi/savi_movie_params-res128.py",
    "SAViMoviD128": "video_based/savi/savi_movid_params-res128.py",
    "SAViMoviSolid128": "video_based/savi/savi_movisolid_params-res128.py",
    "SAViMoviTex128": "video_based/savi/savi_movitex_params-res128.py",
    "STEVEMoviE128": "video_based/steve/steve_movie_params-res128.py",
    "STEVEMoviD128": "video_based/steve/steve_movid_params-res128.py",
    "STEVEMoviSolid128": "video_based/steve/steve_movisolid_params-res128.py",
    "STEVEMoviTex128": "video_based/steve/steve_movitex_params-res128.py",
    "DVAEMoviE128": "video_based/steve/dvae_movie_params-res128.py",
    "DVAEMoviD128": "video_based/steve/dvae_movid_params-res128.py",
    "DVAEMoviSolid128": "video_based/steve/dvae_movisolid_params-res128.py",
    "DVAEMoviTex128": "video_based/steve/dvae_movitex_params-res128.py",
    "DVAECLEVRTex128": "img_based/slate/dvae_clevrtex_params-res128.py",
    "DVAECelebA128": "img_based/slate/dvae_celeba_params-res128.py",
    "SLATECLEVRTex128": "img_based/slate/slate_clevrtex_params-res128.py",
    "SLATECelebA128": "img_based/slate/slate_celeba_params-res128.py",
    "SAViSynthetic64": "savi_synthetic_params-res64.py",
    "DVAESyntheticLong64": "dvae_synthetic_long-res64.py",
    "SLATESyntheticLong64": "slate_synthetic_long-res64.py",
    "STEVESyntheticLong64": "steve_synthetic_long-res64.py",
    "SALDMDINOCOCO224": "img_based/sa_ldm/sa_ldm_dino_coco_params-res224.py",
    "SALDMDINOVOC224": "img_based/sa_ldm/sa_ldm_dino_voc_params-res224.py",
    "VQVAECOCO224": "img_based/sa_ldm/vqvae_coco_params-res224.py",
    "VQVAEVOC224": "img_based/sa_ldm/vqvae_voc_params-res224.py",
    "SASynthetic64": "sa_synthetic_params-res64.py",
    "SACOCOFile64": "sa_coco_file-res64.py",
    "SAVOCFile64": "sa_voc_file-res64.py",
    "SASyntheticCOCO64": "sa_synthetic_coco-res64.py",
    "SAViLDMSyntheticLong3_64": "savi_ldm_synthetic_long3-res64.py",
    "SAViLDMPhysion128":
        "video_based/savi_ldm/savi_ldm_physion_params-res128.py",
    "VQVAEPhysion128": "video_based/savi_ldm/vqvae_physion_params-res128.py",
    "SlotFormerSynthetic": "slotformer_synthetic_params.py",
    "LDMSlotFormerSynthetic64": "ldmslotformer_synthetic_params-res64.py",
    "LDMSlotFormerSynthetic64Long2": "ldmslotformer_synthetic_long2-res64.py",
    "LDMSlotFormerSynthetic64Long3": "ldmslotformer_synthetic_long3-res64.py",
    "LDMSlotFormerPhysion128": "vp_vqa/ldmslotformer_physion_params-res128.py",
    "ReadoutSynthetic": "readout_synthetic_params.py",
    "ReadoutSyntheticRolloutLong": "readout_synthetic_rollout_long.py",
    "ReadoutPhysion": "vp_vqa/readout_physion_params.py"}
# the trainer's keys and the default the JAX trainer reads each with
TRAINER_KEYS = {"optimizer": "adam", "weight_decay": 0.0, "max_steps": -1,
                "save_epoch_end": False, "use_wandb": False,
                "profile_dir": "", "profile_steps": (10, 15),
                "async_ckpt": True, "project": None}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_every_config_is_mapped():
    assert set(JAX_CONFIGS) == set(configs.CONFIGS)


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_trainer_keys_match_the_jax_config(name):
    """optimizer, weight_decay, max_steps, save_epoch_end, use_wandb,
    profile_dir/profile_steps, async_ckpt and project: each port config's
    value is what the JAX trainer reads from its JAX config (the key, or
    the trainer's default where the file has none)."""
    ref = load_params(os.path.join(REPO, "configs", JAX_CONFIGS[name]))
    mine = configs.get_config(name)
    for k, default in TRAINER_KEYS.items():
        want = ref.get(k, default)
        got = getattr(mine, k)
        assert (tuple(got) if k == "profile_steps" else got) == (
            tuple(want) if k == "profile_steps" else want), (name, k)


# the epoch-end visualisation's keys and the default the JAX package reads
# each with (methods/viz.py, training/trainer.py)
VIZ_KEYS = {"use_dpm": True, "use_viz": True, "viz_denoise_rows": True}


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_viz_keys_match_the_jax_config(name):
    """use_dpm (the viz sampler: False on the MOVi and Physion
    SAViDiffusion configs, whose JAX base `SAViLDMBase` takes the
    ancestral chain; True on the synthetic res64 ones), use_viz and
    viz_denoise_rows: each port config's value is what the JAX package
    reads from its JAX config."""
    ref = load_params(os.path.join(REPO, "configs", JAX_CONFIGS[name]))
    mine = configs.get_config(name)
    for k, default in VIZ_KEYS.items():
        assert getattr(mine, k) == ref.get(k, default), (name, k)


# ---- the JAX trainer and the port's on the same settings -----------------

N_VAL = 6  # val batches of 8
SETTINGS = dict(max_epochs=3, max_steps=5, save_epoch_end=True,
                eval_interval=1000, save_interval=1000.0, print_iter=1000,
                lr=1e-3, warmup_steps_pct=0.5, grad_accum_steps=1)
ENC_DEC = dict(resolution=16, in_channels=3, z_channels=3, ch=8,
               ch_mult=[1], num_res_blocks=1, attn_resolutions=[],
               out_ch=3, dropout=0.0)
VQ = dict(n_embed=16, embed_dim=3, percept_loss_w=0.0)


class _Counting:
    """A val loader that starts a count in `passes` for each pass over
    it (`_counted` adds each val batch's evaluation to the last)."""

    def __init__(self, loader, passes):
        self.loader, self.passes = loader, passes

    def __iter__(self):
        self.passes.append(0)
        return iter(self.loader)

    def __len__(self):
        return len(self.loader)


def _counted(fn, passes):
    def wrapped(*args, **kwargs):
        passes[-1] += 1
        return fn(*args, **kwargs)
    return wrapped


def _jax_run(tmp_path):
    """The JAX trainer on a tiny VQ-VAE with `SETTINGS` (2 train batches
    an epoch): -> (val batches of each validation, checkpoint tags)."""
    from slotdiffusion_tpu.data import DataModule as JaxDataModule
    from slotdiffusion_tpu.data.synthetic import \
        SyntheticImageDataset as JaxImages
    from slotdiffusion_tpu.methods import build_method as jax_method
    from slotdiffusion_tpu.models import build_model as jax_model
    from slotdiffusion_tpu.utils import BaseParams
    params = BaseParams()
    for k, v in dict(SETTINGS, model="VQVAE", resolution=(16, 16),
                     train_batch_size=8, val_batch_size=8, num_workers=0,
                     optimizer="sgd", enc_dec_dict=ENC_DEC, vq_dict=VQ,
                     recon_loss_w=1.0, quant_loss_w=1.0).items():
        setattr(params, k, v)
    dm = JaxDataModule(params, JaxImages((16, 16), 16),
                       JaxImages((16, 16), 8 * N_VAL, seed=1))
    passes = []
    dm.val_loader = _Counting(dm.val_loader, passes)
    method = jax_method(model=jax_model(params), datamodule=dm,
                        params=params, ckp_path=str(tmp_path))
    build = method._build_steps

    def build_counted():
        build()
        method._eval_step = _counted(method._eval_step, passes)
    method._build_steps = build_counted
    method.fit(san_check_val_step=2)
    tags = {n[len("ckpt_"):] for n in os.listdir(tmp_path)
            if n.startswith("ckpt_") and "-" not in n}
    return passes, tags, int(jax.device_get(method.state.step))


def _port_trainer(path, **overrides):
    """The port's Trainer on a tiny VQ-VAE with `SETTINGS` (2 train
    batches of 8 an epoch, `N_VAL` val batches); -> (trainer, the val
    batches of each validation)."""
    cfg = configs.VQVAESynthetic64().copy(
        resolution=(16, 16), enc_dec_dict=ENC_DEC, vq_dict=VQ,
        **dict(SETTINGS, **overrides))
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    data = DataModule(SyntheticImageDataset((16, 16), 16, seed=0),
                      SyntheticImageDataset((16, 16), 8 * N_VAL, seed=1), 8)
    trainer = build_method(model, data, cfg, ckp_path=path)
    passes = []
    val = data.val_loader
    data.val_loader = lambda: _Counting(val(), passes)
    trainer.eval_step = _counted(trainer.eval_step, passes)
    return trainer, passes


def test_max_steps_sanity_check_and_epoch_ends_match_the_jax_trainer(
        tmp_path):
    """max_steps 5 of 3 epochs of 2 steps, save_epoch_end, a sanity check
    of 2 val batches: both trainers validate 2 batches, then, at the cap
    (mid-epoch 3), write `last` and validate 4 batches, and write
    `epoch1` and `epoch2` on the way; the port's files load, step 5."""
    jpasses, jtags, jstep = _jax_run(tmp_path / "jax")
    trainer, passes = _port_trainer(str(tmp_path / "port"))
    trainer.fit()
    assert jpasses == passes == [2, 4]
    assert jstep == trainer.step == 5
    tags = {n[len("ckpt_"):-len(".pt")]
            for n in os.listdir(tmp_path / "port") if n.startswith("ckpt_")}
    assert tags == jtags == {"epoch1", "epoch2", "last"}
    assert load_checkpoint(str(tmp_path / "port" / "ckpt_last.pt"))[
        "step"] == 5
    for n, step in (("epoch1", 2), ("epoch2", 4)):
        assert load_checkpoint(str(tmp_path / "port" / f"ckpt_{n}.pt"))[
            "step"] == step


def test_san_check_val_step_zero_and_fit_max_steps(tmp_path):
    """`san_check_val_step=0` validates nothing before the first step; a
    `fit(max_steps=)` argument below the config's cap ends as before:
    all val batches, then ckpt_last."""
    trainer, passes = _port_trainer(str(tmp_path), max_steps=-1)
    trainer.fit(max_steps=3, san_check_val_step=0)
    assert passes == [N_VAL] and trainer.step == 3
    assert load_checkpoint(str(tmp_path / "ckpt_last.pt"))["step"] == 3


def test_profile_writes_a_chrome_trace_of_the_steps(tmp_path):
    """profile_steps (1, 3): a torch.profiler Chrome trace of micro-steps
    1 and 2 under profile_dir, with the steps' operators in it."""
    trainer, _ = _port_trainer(None, profile_dir=str(tmp_path / "prof"),
                               profile_steps=(1, 3), max_steps=4)
    trainer.fit(san_check_val_step=0)
    path = tmp_path / "prof" / "trace_steps1-3.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::convolution") for n in names)
    assert any(n.startswith("Optimizer.step") for n in names)


class _StubWandb(types.ModuleType):
    """A wandb stand-in recording `init` and `log`."""

    def __init__(self):
        super().__init__("wandb")
        self.logged, self.init_kwargs = [], None

    def init(self, **kwargs):
        self.init_kwargs = kwargs

    def log(self, record, step=None):
        self.logged.append((dict(record), step))


def test_wandb_logs_the_jsonl_records_and_falls_back(tmp_path, monkeypatch,
                                                     capsys):
    """use_wandb with a wandb module: `init` gets the project, run name
    and id (resume "allow"), and `log` every JSONL record but its time, at
    its step; without one (import fails) the JSONL log alone, and one line
    says so."""
    stub = _StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    trainer, _ = _port_trainer(str(tmp_path / "a"), use_wandb=True,
                               wandb_id="run-7", wandb_name="tiny",
                               print_iter=1, max_steps=3)
    trainer.fit()
    assert stub.init_kwargs["project"] == "SlotDiffusionTPU"
    assert stub.init_kwargs["id"] == "run-7"
    assert stub.init_kwargs["name"] == "tiny"
    assert stub.init_kwargs["resume"] == "allow"
    lines = [json.loads(x) for x in
             (tmp_path / "a" / "train_log.jsonl").read_text().splitlines()]
    assert len(lines) == len(stub.logged) == 5  # sanity, 3 steps, final val
    for rec, (got, step) in zip(lines, stub.logged):
        rec.pop("time")
        assert got == rec and step == rec["step"]

    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    capsys.readouterr()
    trainer, _ = _port_trainer(str(tmp_path / "b"), use_wandb=True,
                               max_steps=1)
    out = capsys.readouterr().out
    assert out.count("[wandb]") == 1 and "JSONL log alone" in out
    trainer.fit(san_check_val_step=0)
    assert (tmp_path / "b" / "train_log.jsonl").read_text().count(
        "\n") == 2


def _same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        elif isinstance(a[k], dict):
            _same_state(a[k], b[k])
        elif isinstance(a[k], (list, tuple)):
            _same_state(dict(enumerate(a[k])), dict(enumerate(b[k])))
        else:
            assert a[k] == b[k], k


def test_async_and_blocking_saves_and_resume_from_an_async_save(tmp_path):
    """async_ckpt True and False give the same files; the async
    `ckpt_epoch1` (written while steps 3-4 run) resumes to a run equal to
    the uninterrupted one bit for bit; a save writes its file only after
    the state was copied (training on does not reach it)."""
    runs = {}
    for flag in (True, False):
        trainer, _ = _port_trainer(str(tmp_path / str(flag)),
                                   async_ckpt=flag, max_steps=-1)
        trainer.fit(max_steps=4, san_check_val_step=0)
        runs[flag] = trainer
        assert trainer._saving is None
    for name in ("ckpt_epoch1.pt", "ckpt_epoch2.pt", "ckpt_last.pt"):
        _same_state(load_checkpoint(str(tmp_path / "True" / name)),
                    load_checkpoint(str(tmp_path / "False" / name)))
    resumed, _ = _port_trainer(None, max_steps=-1)
    resumed.fit(max_steps=4, san_check_val_step=0,
                resume_from=str(tmp_path / "True" / "ckpt_epoch1.pt"))
    for (n, p), q in zip(runs[True].model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(p, q), n
    _same_state(runs[True].optimizer.state_dict()["core"],
                resumed.optimizer.state_dict()["core"])


def test_kernel_launches_carry_their_operator_spans():
    """Each model kernel's launch function (GN, attention, slot
    attention) runs inside a span named by its `sdt::` operator while a
    torch.profiler trace records, so a trace of eager training steps on
    the card names them; outside a trace the span is not entered."""
    from torch.profiler import profile

    from slotdiffusion_tpu_torch.ops import (_cuda, attention_kernel,
                                             fused_norm,
                                             slot_attention_kernel)
    for mod, op in ((fused_norm, "sdt::group_norm"),
                    (attention_kernel, "sdt::mha"),
                    (slot_attention_kernel, "sdt::sa_iterations")):
        assert mod._launch.__wrapped__ is not None, op
    calls = []
    traced = _cuda.traced("sdt::probe")(lambda x: calls.append(x) or x)
    traced(1)
    with profile() as prof:
        traced(2)
    assert calls == [1, 2]
    assert [e.name for e in prof.events()].count("sdt::probe") == 1
