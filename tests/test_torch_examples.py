"""Every ``examples/torch_*.py`` runs on the CPU (``--device cpu``) at its
own smallest settings, and says what it claims (no JAX)."""
import importlib.util
import os

import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _main(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_examples_are_the_reference_set():
    ref = sorted(f[:-3] for f in os.listdir(EXAMPLES)
                 if f.endswith(".py") and not f.startswith("torch_"))
    port = sorted(f[len("torch_"):-3] for f in os.listdir(EXAMPLES)
                  if f.startswith("torch_") and f.endswith(".py"))
    assert port == ref


def test_quickstart():
    rec = _main("quickstart")(["--device", "cpu", "--n", "4000"])
    assert rec["B"] >= rec["A"] and rec["B"] > 0.5


def test_counterfactual_branch():
    out = _main("counterfactual_branch")(["--device", "cpu"])
    assert out["hit_a"] == out["own"] and out["hit_parent"] < 3000
    assert all(i >= 3000 for i in out["tagged"])
    assert all(0 <= i < 3000 for i in out["timed"])


def test_distributed_search():
    out = _main("distributed_search")(["--device", "cpu", "--n", "8192"])
    assert all(out[f"{s} shards"] for s in (2, 4, 8)) and out["2 x 4"]
    assert out["self-retrieval 8"] >= out["self-retrieval 1"]


def test_long_context_decode():
    out = _main("long_context_decode")(["--device", "cpu", "--grains", "4"])
    assert torch.isfinite(out["logits"]).all()
    assert len(out["top_retrieval"]) == 5


def test_serve_retrieval():
    out = _main("serve_retrieval")(["--device", "cpu", "--requests", "2"])
    assert len(out) == 2
    assert all(all(r["topic_match"]) for r in out)
    assert all(len(r["generated"]) == 8 for r in out)


def test_train_lm(tmp_path):
    losses = _main("train_lm")(["--device", "cpu", "--host-mesh", "2,2",
                                "--steps", "2", "--batch", "4", "--seq",
                                "16", "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and all(l == l for l in losses)


def test_train_lm_host_mesh_takes_a_card_per_slot(tmp_path, monkeypatch):
    """Without --device a host mesh takes one card per slot and refuses
    a mesh larger than the cards there are (never doubling up)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 4 devices, found 1"):
        _main("train_lm")(["--host-mesh", "2,2", "--steps", "2",
                           "--ckpt-dir", str(tmp_path)])
