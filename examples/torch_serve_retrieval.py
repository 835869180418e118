"""RAG serving on the PyTorch port: an HNTL vector memory as the retrieval
tier next to an LM.

Documents live in the Aperon store (sealed HNTL segments + cold raw
tier); each request embeds its query (stub embedder), retrieves top-k docs
with Mode B, prepends their tokens to the prompt, and generates with the
batched serving engine.  Runs on the card; ``--device cpu`` for the plain
path.

  PYTHONPATH=src python examples/torch_serve_retrieval.py
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core import HNTLConfig
from repro_torch.core.index import resolve_device
from repro_torch.core.store import VectorStore
from repro_torch.models import get_model
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--requests", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    d_embed, n_docs = 64, 2000

    # ---- document memory: clustered topics, each doc has a token payload --
    topics = rng.standard_normal((8, d_embed)).astype(np.float32) * 2
    topic_of = rng.integers(0, 8, n_docs)
    doc_embed = (topics[topic_of]
                 + 0.2 * rng.standard_normal((n_docs, d_embed))).astype(
                     np.float32)
    store = VectorStore(HNTLConfig(d=d_embed, k=16, s=0, n_grains=8,
                                   nprobe=4, pool=16, block=64),
                        seal_threshold=1024, cold_tier=True, device=device)
    store.add(doc_embed, tags=[1 << int(t) for t in topic_of])
    store.seal()
    doc_tokens = rng.integers(0, 500, size=(n_docs, 8)).astype(np.int32)

    # ---- LM ---------------------------------------------------------------
    cfg = dataclasses.replace(get_smoke_config("gemma2-2b"), n_layers=2)
    model = get_model(cfg)
    params = model.init(0, device=device)
    # memory= attaches the store as the engine's retrieval tier: every
    # engine.retrieve() is one fused stacked-segment search
    engine = ServeEngine(model, params, n_slots=2, max_len=128, memory=store)

    # ---- requests: embed -> retrieve (Mode B) -> stuff -> generate --------
    out = []
    for qi in range(args.requests):
        topic = int(rng.integers(0, 8))
        q_embed = topics[topic] + 0.1 * rng.standard_normal(d_embed)
        res = engine.retrieve(q_embed.astype(np.float32)[None], topk=3,
                              mode="B", tag_mask=1 << topic)
        hit_ids = res.ids[0].cpu().numpy()
        correct = [bool(topic_of[h] == topic) for h in hit_ids if h >= 0]
        context = np.concatenate([doc_tokens[h] for h in hit_ids if h >= 0])
        prompt = np.concatenate([context, rng.integers(0, 500, size=4)])
        req = engine.submit(prompt.astype(np.int32), max_new=8)
        engine.run_to_completion()
        print(f"request {qi}: topic {topic}, retrieved docs "
              f"{hit_ids.tolist()} (topic match: {correct}), generated "
              f"{req.out}")
        out.append(dict(topic_match=correct, generated=list(req.out)))
    return out


if __name__ == "__main__":
    main()
