"""PyTorch port of the training launcher (``launch/train.py``) against the
reference on the CPU: the port's forms of ``test_train_loop_and_resume``,
``test_straggler_watchdog`` and ``test_one_train_step_reduces_loss_direction``,
a 4-step loss curve of ``make_train_step`` against the reference's from
the same init (``jax.random.PRNGKey(0)`` carried across) and the same
data (``synthetic_batches``), and checkpoints crossing packages: one
written by ``repro.launch.train.run`` resumes in the port's ``run`` and
the next step's loss is the reference's next step's, and the other way
round.

Tolerance 1e-4 (absolute and relative) in f32 on losses, grad norms and
the parameters after the steps: the two sides sum in other orders,
nothing else.
"""
import dataclasses
import itertools
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data import tokens as JD
from repro.launch import train as JTR
from repro.models import registry as JREG
from repro.optim import adamw as JA
from repro_torch import configs as TC
from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.data import tokens as TD
from repro_torch.launch import train as TTR
from repro_torch.models import registry as TREG
from repro_torch.models import rwkv6 as TR
from repro_torch.models import transformer as TT
from repro_torch.models import whisper as TW
from repro_torch.models.common import flat_params
from repro_torch.optim import adamw as TA

TOL = 1e-4
FROM_NUMPY = {"dense": TT, "vlm": TT, "ssm": TR, "audio": TW}


def test_train_loop_and_resume(tmp_path):
    cfg = TC.get_reduced("smollm_135m")
    api = TREG.build(cfg, device="cpu")
    tc = TTR.TrainConfig(steps=6, ckpt_every=3, log_every=100,
                         ckpt_dir=str(tmp_path),
                         opt=TA.AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=6))
    out = TTR.run(api, tc, batch_size=2, seq=16, verbose=False)
    assert len(out["losses"]) == 6
    assert np.isfinite(out["losses"]).all()
    assert int(out["opt_state"].step) == 6
    # resume: a second run picks up from the saved step (6)
    tc2 = TTR.TrainConfig(steps=8, ckpt_every=4, log_every=100,
                          ckpt_dir=str(tmp_path), opt=tc.opt)
    out2 = TTR.run(api, tc2, batch_size=2, seq=16, verbose=False)
    assert len(out2["losses"]) == 2       # only steps 6, 7 executed
    assert int(out2["opt_state"].step) == 8


def test_run_saves_no_checkpoint_at_ckpt_every_0(tmp_path):
    """``ckpt_every`` 0 trains without writing a checkpoint (the full-width
    recurrentgemma cell's setting); the losses are those of a run that
    saves one."""
    api = TREG.build(TC.get_reduced("smollm_135m"), device="cpu")
    opt = TA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    runs = {}
    for every in (0, 3):
        ckdir = tmp_path / str(every)
        ckdir.mkdir()
        tc = TTR.TrainConfig(steps=3, ckpt_every=every, log_every=100,
                             ckpt_dir=str(ckdir), opt=opt)
        runs[every] = TTR.run(api, tc, batch_size=2, seq=16, verbose=False)
        assert any(ckdir.iterdir()) == (every > 0)
    assert runs[0]["losses"] == runs[3]["losses"]
    assert int(runs[0]["opt_state"].step) == 3


def test_straggler_watchdog():
    dog = TTR.StragglerWatchdog(factor=3.0)
    for _ in range(10):
        assert not dog.observe(0.1)
    assert dog.observe(1.0)
    assert dog.flagged == 1


@pytest.mark.parametrize("name", JC.ALL_ARCHS)
def test_one_train_step_reduces_loss_direction(name):
    """One AdamW step on a fixed batch does not blow up the loss (the
    reference's check, on the port's own init)."""
    cfg = TC.get_reduced(name)
    api = TREG.build(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(1))
    batch = TREG.make_batch(cfg, 2, 8, device="cpu")
    opt = TA.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    state = TA.init(flat_params(api.param_tree(model)))
    _, state, m = TTR.make_train_step(api, opt)(model, state, batch)
    with torch.inference_mode():
        loss1 = float(api.loss(model, batch))
    assert np.isfinite(loss1)
    assert loss1 < float(m["loss"]) + 1.0


def reference_steps(jcfg, opt, n):
    japi = JREG.build(jcfg)
    params = japi.init(jax.random.PRNGKey(0))
    state = JA.init(params)
    step = jax.jit(JTR.make_train_step(japi, opt))
    metrics = []
    for batch in itertools.islice(JD.synthetic_batches(jcfg, 2, 16), n):
        params, state, m = step(params, state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        float(m["lr"])))
    return metrics, params, state


@pytest.mark.parametrize("name", ["smollm_135m", "rwkv6_1_6b",
                                  "internvl2_1b", "whisper_medium"])
def test_four_step_loss_curve_matches_the_reference(name):
    """The batches are ``synthetic_batches``' numpy arrays on both sides,
    whisper's frames and internvl2's patches f32 as the model casts them
    (``launch/train.py::run`` moves them to the device unchanged).
    (No gradient compression: int8's rounding steps turn an f32
    difference in the last bit into a whole quantisation step, so a curve
    through it cannot be held at 1e-4; the round trip itself is held bit
    for bit on equal inputs in tests/test_torch_optim.py.)"""
    jcfg, tcfg = JC.get_reduced(name), TC.get_reduced(name)
    opt = TA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    want, jparams, jstate = reference_steps(
        jcfg, JA.AdamWConfig(**dataclasses.asdict(opt)), 4)
    api = TREG.build(tcfg, device="cpu")
    model = FROM_NUMPY[tcfg.family].params_from_numpy(
        jax.tree_util.tree_map(np.asarray,
                               JREG.build(jcfg).init(jax.random.PRNGKey(0))),
        tcfg, "cpu")
    state = TA.init(flat_params(api.param_tree(model)))
    step = TTR.make_train_step(api, opt)
    got = []
    for batch in itertools.islice(TD.synthetic_batches(tcfg, 2, 16), 4):
        model, state, m = step(model, state, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
        got.append((float(m["loss"]), float(m["grad_norm"]),
                     float(m["lr"])))
    np.testing.assert_allclose(np.array(got), np.array(want), atol=TOL,
                               rtol=TOL)
    ckpt_tree = TTR.checkpoint_tree(api, model, state)
    for g, w in zip(tree_flatten(ckpt_tree)[0],
                    jax.tree_util.tree_leaves((jparams, jstate))):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), atol=TOL,
                                   rtol=TOL)


def test_checkpoints_resume_across_packages(tmp_path):
    """A reference checkpoint (reduced f32 smollm, step 3) resumes in the
    port's ``run`` and a port checkpoint in the reference's: each next
    step's loss equals the reference's resumed step's."""
    jcfg, tcfg = JC.get_reduced("smollm_135m"), TC.get_reduced("smollm_135m")
    opt = TA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6)
    jopt = JA.AdamWConfig(**dataclasses.asdict(opt))
    cfg3 = lambda d, cls, o: cls(steps=3, ckpt_every=3, log_every=100,
                                 ckpt_dir=str(d), opt=o)
    cfg4 = lambda d, cls, o: dataclasses.replace(cfg3(d, cls, o), steps=4)
    japi = JREG.build(jcfg)
    api = TREG.build(tcfg, device="cpu")
    # the reference writes step 3; both packages resume from a copy
    JTR.run(japi, cfg3(tmp_path / "ref", JTR.TrainConfig, jopt),
            batch_size=2, seq=16, verbose=False)
    shutil.copytree(tmp_path / "ref", tmp_path / "ref_for_port")
    want = JTR.run(japi, cfg4(tmp_path / "ref", JTR.TrainConfig, jopt),
                   batch_size=2, seq=16, verbose=False)["losses"]
    got = TTR.run(api, cfg4(tmp_path / "ref_for_port", TTR.TrainConfig, opt),
                  batch_size=2, seq=16, verbose=False)
    assert len(got["losses"]) == len(want) == 1
    np.testing.assert_allclose(got["losses"], want, atol=TOL, rtol=TOL)
    assert int(got["opt_state"].step) == 4
    # the port writes step 3; the reference resumes from it
    TTR.run(api, cfg3(tmp_path / "port", TTR.TrainConfig, opt),
            batch_size=2, seq=16, verbose=False)
    shutil.copytree(tmp_path / "port", tmp_path / "port_for_ref")
    want = TTR.run(api, cfg4(tmp_path / "port", TTR.TrainConfig, opt),
                   batch_size=2, seq=16, verbose=False)["losses"]
    got = JTR.run(japi, cfg4(tmp_path / "port_for_ref", JTR.TrainConfig,
                             jopt), batch_size=2, seq=16,
                  verbose=False)["losses"]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_checkpoint_tree_round_trip_is_bit_for_bit(tmp_path):
    """``checkpoint_tree`` -> save -> restore -> ``load_checkpoint`` gives
    back every weight, moment and the step bit for bit (bf16 weights,
    f32 moments), into a model of other weights."""
    cfg = dataclasses.replace(TC.get_reduced("rwkv6_1_6b"),
                              dtype=torch.bfloat16)
    api = TREG.build(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(0))
    state = TA.init(flat_params(api.param_tree(model)))
    _, state, _ = TTR.make_train_step(api, TA.AdamWConfig(warmup_steps=0))(
        model, state, TREG.make_batch(cfg, 2, 8, device="cpu"))
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(TTR.checkpoint_tree(api, model, state), step=1)
    other = api.init(torch.Generator().manual_seed(1))
    st2 = TA.init(flat_params(api.param_tree(other)))
    restored = mgr.restore(TTR.checkpoint_template(api, other), 1)
    st2 = TTR.load_checkpoint(api, other, st2, restored)
    assert int(st2.step) == 1 and st2.step.dtype == torch.int32
    for a, b in zip(flat_params(api.param_tree(model)) + state.m + state.v,
                    flat_params(api.param_tree(other)) + st2.m + st2.v):
        assert a.dtype == b.dtype
        assert torch.equal(a.detach().view(torch.int16) if a.dtype ==
                           torch.bfloat16 else a.detach(),
                           b.detach().view(torch.int16) if b.dtype ==
                           torch.bfloat16 else b.detach())


def test_main_trains_on_the_cpu(tmp_path, capsys):
    TTR.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
              "--steps", "2", "--batch", "2", "--seq", "8", "--ckpt-dir",
              str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] step     1 loss" in out and "final loss:" in out
