"""The port's trainer, checkpoints, token data and training launcher.

- ``data.tokens``: ``MarkovLM`` and ``random_batch`` batches equal the
  JAX package's copy bit for bit;
- twins of ``tests/test_train.py`` (loss falls on Markov data, resume
  replays deterministically, microbatch equivalence, NaN guard,
  straggler monitor) and of ``tests/test_checkpoint.py`` (round trip,
  keep-N, async save, no partial directories, dtype cast on restore), a
  bf16 round trip with no ``ml_dtypes`` importable, and a checkpoint the
  JAX package wrote read back;
- SIGTERM mid-run checkpoints and stops; serving records no autograd
  graph when the parameters require gradients;
- ``launch.train`` on the CPU, its refusal of ``--host-mesh 2,1`` on one
  card when no ``--device`` is given, and its need of a card then.

Only the checkpoint-interchange test imports JAX (``importorskip``).
"""
import dataclasses
import json
import os
import signal
import sys
import time

import numpy as np
import pytest
import torch

from repro.data import tokens as ref_tokens
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import MarkovLM, random_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.optim.adamw import AdamW, constant, warmup_cosine
from repro_torch.train.step import (init_state, make_eval_step,
                                    make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                              n_layers=2, vocab=128)
    return cfg, get_model(cfg)


def _data_fn(cfg, seed, b, s):
    data = MarkovLM(vocab=cfg.vocab, seed=seed)
    return lambda step: {k: torch.from_numpy(v)
                         for k, v in data.batch(step, b, s).items()}


def _trainer(model, opt, data_fn, ckpt_dir, **kw):
    return Trainer(model, opt, data_fn,
                   TrainerConfig(ckpt_dir=str(ckpt_dir), **kw),
                   device="cpu")


def _leaves(state) -> dict:
    out = {f"params.{k}": v.detach()
           for k, v in state.params.named_parameters()}
    for part in ("m", "v"):
        out.update({f"{part}.{k}": v
                    for k, v in state.opt_state[part].items()})
    return out


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("kw", [dict(step=0, batch_size=8, seq_len=32),
                                dict(step=17, batch_size=4, seq_len=16),
                                dict(step=3, batch_size=8, seq_len=8,
                                     shard=1, n_shards=2)])
def test_markov_batches_equal_the_reference(kw):
    for vocab, seed in ((128, 0), (512, 5)):
        got = MarkovLM(vocab=vocab, seed=seed).batch(**kw)
        want = ref_tokens.MarkovLM(vocab=vocab, seed=seed).batch(**kw)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(
        random_batch(3, 4, 16, 100, seed=2)["tokens"],
        ref_tokens.random_batch(3, 4, 16, 100, seed=2)["tokens"])
    with pytest.raises(ValueError, match="shards"):
        MarkovLM(vocab=16).batch(0, 5, 4, n_shards=2)


# ---------------------------------------------------- tests/test_train.py


def test_loss_decreases_on_markov_data(tiny, tmp_path):
    cfg, model = tiny
    trainer = _trainer(model, AdamW(lr=warmup_cosine(3e-3, 5, 60)),
                       _data_fn(cfg, 0, 8, 32), tmp_path, total_steps=40,
                       ckpt_every=20, log_every=20)
    trainer.run()
    losses = [h["loss"] for h in trainer.history]
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert losses[-1] < np.log(cfg.vocab)          # beats uniform


def test_resume_replays_deterministically(tiny, tmp_path):
    cfg, model = tiny
    data_fn = _data_fn(cfg, 1, 4, 16)

    def make(total, d):
        return _trainer(model, AdamW(lr=constant(1e-3)), data_fn, d,
                        total_steps=total, ckpt_every=10, log_every=100)

    make(10, tmp_path / "a").run()                 # stops at 10, saves
    state = make(20, tmp_path / "a").run()         # resumes from step 10
    assert state.step == 20 and state.opt_state["count"] == 20
    full = _trainer(model, AdamW(lr=constant(1e-3)), data_fn,
                    tmp_path / "b", total_steps=20, ckpt_every=100,
                    log_every=100).run()
    got, want = _leaves(state), _leaves(full)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=k)


def test_microbatch_equivalence(tiny):
    """Grad accumulation over M microbatches == one full batch step."""
    cfg, model = tiny
    opt = AdamW(lr=constant(1e-3), max_grad_norm=None)
    states = [init_state(model, opt, 0, "cpu") for _ in range(2)]
    batch = _data_fn(cfg, 2, 8, 16)(0)
    s1, m1 = make_train_step(model, opt, microbatches=1)(states[0], batch)
    s2, m2 = make_train_step(model, opt, microbatches=4)(states[1], batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-2)
    # params are bf16: one-ulp disagreements after the update are expected
    # (fwd/bwd in different batch groupings); bound by bf16 resolution.
    for (k, a), (_, b) in zip(s1.params.named_parameters(),
                              s2.params.named_parameters()):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(), rtol=5e-2,
                                   atol=4e-3, err_msg=k)


def test_eval_step_is_the_loss_without_a_graph(tiny):
    cfg, model = tiny
    state = init_state(model, AdamW(lr=constant(1e-3)), 0, "cpu")
    batch = _data_fn(cfg, 7, 2, 8)(0)
    out = make_eval_step(model)(state.params, batch)
    loss, metrics = model.loss(state.params, batch)
    assert not out["loss"].requires_grad
    assert torch.equal(out["loss"], loss.detach())
    assert torch.equal(out["ce"], metrics["ce"].detach())


def test_nan_guard(tiny, tmp_path):
    cfg, model = tiny
    tr = _trainer(model, AdamW(lr=constant(float("nan"))),
                  _data_fn(cfg, 3, 2, 8), tmp_path, total_steps=5,
                  ckpt_every=100, log_every=100)
    with pytest.raises(FloatingPointError):
        tr.run()


def test_straggler_monitor(tiny, tmp_path):
    cfg, model = tiny
    events = []
    tr = _trainer(model, AdamW(lr=constant(1e-3)), _data_fn(cfg, 4, 2, 8),
                  tmp_path, total_steps=12, ckpt_every=100, log_every=100,
                  straggler_factor=3.0)
    tr.straggler_cb = lambda s, dt, ew: events.append((s, dt))
    orig = tr.train_step

    def slow_step(state, batch):                   # synthetic straggler node
        if state.step == 8 and tr.history:
            # sleep long relative to the *measured* step time so the test
            # is robust to background CPU contention
            recent = np.mean([h["time_s"] for h in tr.history[-3:]])
            time.sleep(max(0.5, 4.0 * recent))
        return orig(state, batch)

    tr.train_step = slow_step
    tr.run()
    assert tr.straggler_events >= 1 and events


def test_sigterm_checkpoints_and_stops(tiny, tmp_path):
    """SIGTERM during step 3's batch: step 3 finishes, the loop stops, the
    final checkpoint holds step 4, and the previous handler is back."""
    cfg, model = tiny
    data = _data_fn(cfg, 5, 2, 8)

    def data_fn(step):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return data(step)

    before = signal.getsignal(signal.SIGTERM)
    tr = _trainer(model, AdamW(lr=constant(1e-3)), data_fn, tmp_path,
                  total_steps=10, ckpt_every=100, log_every=100)
    state = tr.run()
    assert state.step == 4 and tr.ckpt.all_steps() == [4]
    assert signal.getsignal(signal.SIGTERM) is before


def test_serving_records_no_graph_after_training(tiny):
    from repro_torch.serve.engine import ServeEngine

    cfg, model = tiny
    params = init_state(model, AdamW(lr=constant(1e-3)), 0, "cpu").params
    assert all(p.requires_grad for p in params.parameters())
    tokens = torch.arange(6)[None].repeat(2, 1)
    logits, caches = model.prefill(params, tokens, max_len=8)
    assert not logits.requires_grad
    assert not caches[0]["mixer"]["k"].requires_grad
    logits, _ = model.decode_step(params, tokens[:, 0], caches,
                                  torch.full((2,), 6))
    assert not logits.requires_grad
    engine = ServeEngine(model, params, n_slots=2, max_len=16)
    req = engine.submit(np.arange(3, 7), max_new=3)
    engine.run_to_completion()
    assert req.done and not engine.caches[0]["mixer"]["k"].requires_grad
    wcfg = get_smoke_config("whisper-base")
    wmodel = get_model(wcfg)
    wparams = wmodel.init(0, device="cpu").requires_grad_(True)
    assert not wmodel.encode(wparams, torch.zeros(1, 8, wcfg.d_model)) \
        .requires_grad


# ----------------------------------------------- tests/test_checkpoint.py


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal((4, 8))).to(
        torch.bfloat16),
            "nested": {"b": torch.arange(7, dtype=torch.int32),
                       "c": torch.tensor(3.5, dtype=torch.float32)}}


def _flat(tree):
    return [tree["a"], tree["nested"]["b"], tree["nested"]["c"]]


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    tree = _tree()
    mgr.save(tree, step=5)
    abstract = {"a": torch.empty((4, 8), dtype=torch.bfloat16,
                                 device="meta"),
                "nested": {"b": torch.empty(7, dtype=torch.int32,
                                            device="meta"),
                           "c": torch.empty((), device="meta")}}
    out = mgr.restore(abstract)
    for a, b in zip(_flat(tree), _flat(out)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


def test_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save(_tree(s), step=s)
    assert mgr.all_steps() == [3, 4]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    tree = _tree()
    mgr.save(tree, step=7, blocking=False)
    tree["a"].fill_(0)                 # the snapshot is a copy
    mgr.wait()
    assert mgr.latest_step() == 7
    out = mgr.restore(_tree(1))
    np.testing.assert_array_equal(out["a"].float().numpy(),
                                  _tree()["a"].float().numpy())


def test_atomic_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    mgr.save(_tree(), step=1)
    for d in os.listdir(tmp_path):
        assert not d.startswith(".tmp"), d
        man = os.path.join(tmp_path, d, "manifest.json")
        assert os.path.exists(man)
        with open(man) as f:
            json.load(f)                           # valid json


def test_restore_with_dtype_cast(tmp_path):
    """Restore into a different param dtype (e.g. bf16 -> f32 promote)."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(tree, step=1)
    target = {"a": torch.zeros((4, 8)),
              "nested": {"b": torch.zeros(7), "c": torch.zeros(())}}
    out = mgr.restore(target)
    assert out["a"].dtype == torch.float32 and out["a"] is target["a"]
    np.testing.assert_array_equal(out["a"].numpy(),
                                  tree["a"].float().numpy())


def test_bf16_round_trip_without_ml_dtypes(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)   # import fails
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(tree, step=2)
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        entry = json.load(f)["leaves"][0]
    assert entry["name"] == "['a']" and entry["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_00000002" / entry["file"]).dtype \
        == np.uint16
    out = mgr.restore(_tree(1))
    assert torch.equal(out["a"], tree["a"])


def test_restore_reads_a_reference_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote (bf16 through ml_dtypes) reads
    back into the port's tree of the same names."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.checkpoint.manager import CheckpointManager as JaxManager

    tree = _tree()
    JaxManager(str(tmp_path)).save(
        {"a": jnp.asarray(tree["a"].float().numpy(), jnp.bfloat16),
         "nested": {"b": jnp.asarray(tree["nested"]["b"].numpy()),
                    "c": jnp.float32(3.5)}}, step=3)
    out = CheckpointManager(str(tmp_path)).restore(_tree(1))
    for a, b in zip(_flat(tree), _flat(out)):
        assert torch.equal(a, b)


def test_train_state_round_trip(tiny, tmp_path):
    """A whole ``TrainState`` (a module's parameters, the moments by
    name, count and step) restores in place into a fresh state."""
    cfg, model = tiny
    opt = AdamW(lr=constant(1e-3))
    state = init_state(model, opt, 0, "cpu")
    state, _ = make_train_step(model, opt)(state, _data_fn(cfg, 6, 2, 8)(0))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=state.step)
    fresh = init_state(model, opt, 1, "cpu")
    out = mgr.restore(fresh)
    assert out.step == 1 and out.opt_state["count"] == 1
    assert out.params is fresh.params
    got, want = _leaves(out), _leaves(state)
    assert all(torch.equal(got[k], want[k]) for k in want)


# ----------------------------------------------------------- launch.train


def test_launch_train_on_cpu(tmp_path, capsys):
    state = launch_train.main([
        "--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
        "--steps", "4", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
        "--ckpt-dir", str(tmp_path)])
    assert state.step == 4
    assert state.params.embedding.device.type == "cpu"
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    assert "[train] first loss" in capsys.readouterr().out


def test_default_ckpt_dirs_are_fresh_and_resume_nothing(tiny, tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    cfg, model = tiny
    runs = []
    for _ in range(2):
        tr = Trainer(model, AdamW(lr=constant(1e-3)),
                     _data_fn(cfg, 0, 2, 8),
                     TrainerConfig(total_steps=2, ckpt_every=100,
                                   log_every=100), device="cpu")
        state = tr.run()
        runs.append((tr.ckpt, [h["step"] for h in tr.history], state))
    (first, hist0, _), (second, hist1, state) = runs
    assert first.directory != second.directory
    assert os.path.dirname(first.directory) == str(tmp_path)
    assert hist0 == hist1 == [0, 1] and state.step == 2
    assert first.all_steps() == second.all_steps() == [2]


def test_launch_train_refuses_a_host_mesh(tmp_path, monkeypatch):
    """Without --device a host mesh takes one card per slot and refuses
    a mesh larger than the cards there are (never doubling up)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, found 1"):
        launch_train.main(["--arch", "phi3-mini-3.8b", "--smoke",
                           "--host-mesh", "2,1",
                           "--ckpt-dir", str(tmp_path)])


def test_launch_train_without_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "phi3-mini-3.8b", "--smoke",
                           "--ckpt-dir", str(tmp_path)])
