"""Self-distillation for the learned draft heads: no external data.

Port of ``deepspeed_tpu/inference/v2/spec/distill.py``. The corpus comes from
the port's ``generate`` and the hidden states from the port's
``verify_tree``; the heads and the Adam loop stay numpy on the host. Run it
as ``python -m deepspeed_tpu_torch.inference.v2.spec.distill --out heads.npz``
(the built-in tiny model, on the GPU unless ``--device cpu``).

Role model: the Medusa training recipe — the draft heads learn to imitate
the TARGET model on the target model's OWN outputs. The corpus is generated
in-process through the engine's generate path, the hidden states come from
teacher-forced chain feeds through the tree-verify program (which returns
the pre-unembed residuals for free), and the optimizer is a hand-written
numpy Adam so training runs anywhere the serving host runs.

Offset alignment (spec/learned.py): the hidden state at sequence position
``t`` already produced token ``t + 1`` through the target's unembed, so
head ``h`` trains to predict token ``t + 2 + h``.
"""

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.v2.spec.learned import MedusaDraftHead
from deepspeed_tpu_torch.inference.v2.spec.tree import TokenTree

# uid range reserved for distillation feeds: the engine is dedicated while
# training (the hybrid engine flips out of training mode), but a fleet
# operator may still hold live uids below this
_DISTILL_UID = 1 << 20


def build_corpus(engine, prompts: Sequence[Sequence[int]], max_new_tokens: int = 48,
                 temperature: float = 0.0, seed: int = 0) -> List[List[int]]:
    """Prompt + generated continuation per prompt, via the engine's own
    serving-scheduler generate driver (greedy by default — the draft heads
    should imitate the mode the verifier accepts against)."""
    from deepspeed_tpu_torch.inference.v2 import engine_factory
    gens = engine_factory.generate(engine, [list(p) for p in prompts],
                                   max_new_tokens=max_new_tokens,
                                   temperature=temperature, seed=seed)
    return [list(p) + list(g) for p, g in zip(prompts, gens)]


def collect_hidden(engine, sequences: Sequence[Sequence[int]],
                   chunk: int = 32) -> List[np.ndarray]:
    """Teacher-forced hidden states ``[len(seq), hidden]`` per sequence: each
    sequence replays as chain trees through ``verify_tree`` on a scratch uid
    (one ragged dispatch per chunk — the same program the serving tree-verify
    path runs, so train-time and serve-time hidden states match bitwise)."""
    out = []
    for i, seq in enumerate(sequences):
        uid = _DISTILL_UID + i
        toks = np.asarray(seq, np.int32).reshape(-1)
        hs = []
        try:
            for s in range(0, toks.size, chunk):
                tree = TokenTree.chain(toks[s:s + chunk])
                res = engine.verify_tree([uid], [tree], greedy=True)[0]
                hs.append(np.asarray(res["hidden"], np.float32))
        finally:
            engine.flush(uid)
        out.append(np.concatenate(hs, axis=0))
    return out


def make_dataset(sequences: Sequence[Sequence[int]], hiddens: Sequence[np.ndarray],
                 num_heads: int) -> Tuple[np.ndarray, np.ndarray]:
    """(hidden [N, H], targets [num_heads, N]) pairs: position ``t``'s hidden
    state labeled with tokens ``t + 2 .. t + 1 + num_heads``."""
    X, Y = [], []
    for toks, hid in zip(sequences, hiddens):
        toks = list(toks)
        for t in range(len(toks) - num_heads - 1):
            X.append(hid[t])
            Y.append([toks[t + 2 + h] for h in range(num_heads)])
    if not X:
        raise ValueError("corpus too short for the head offsets: need sequences "
                         f"longer than num_heads + 1 = {num_heads + 1} tokens")
    return np.stack(X).astype(np.float32), np.asarray(Y, np.int64).T


def train(head: MedusaDraftHead, hidden: np.ndarray, targets: np.ndarray,
          steps: int = 150, lr: float = 3e-3, batch_size: int = 256,
          seed: int = 0) -> List[float]:
    """Minibatch Adam over the distillation pairs; returns the per-step loss
    trace (the smoke gate asserts it decreases)."""
    rng = np.random.default_rng(seed)
    N = hidden.shape[0]
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = [{k: np.zeros_like(v) for k, v in p.items()} for p in head.params]
    v = [{k: np.zeros_like(vv) for k, vv in p.items()} for p in head.params]
    losses = []
    for step in range(1, steps + 1):
        idx = rng.choice(N, size=min(batch_size, N), replace=False)
        loss, grads = head.loss_and_grads(hidden[idx], targets[:, idx])
        losses.append(loss)
        for h, g in enumerate(grads):
            for k in g:
                m[h][k] = b1 * m[h][k] + (1 - b1) * g[k]
                v[h][k] = b2 * v[h][k] + (1 - b2) * g[k] ** 2
                mhat = m[h][k] / (1 - b1 ** step)
                vhat = v[h][k] / (1 - b2 ** step)
                head.params[h][k] = (head.params[h][k]
                                     - lr * mhat / (np.sqrt(vhat) + eps)).astype(np.float32)
    return losses


def self_distill(engine, prompts: Optional[Sequence[Sequence[int]]] = None,
                 num_heads: int = 3, max_new_tokens: int = 48,
                 num_prompts: int = 4, prompt_len: int = 8,
                 steps: int = 150, lr: float = 3e-3, seed: int = 0,
                 head: Optional[MedusaDraftHead] = None
                 ) -> Tuple[MedusaDraftHead, List[float]]:
    """End-to-end in-process distillation: generate a corpus from the target
    model itself (seeded random prompts when none given — no external data),
    collect teacher-forced hidden states, train fresh (or provided) heads.
    Returns ``(head, loss_trace)``."""
    cfg = engine.model.config
    if prompts is None:
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len).tolist()
                   for _ in range(num_prompts)]
    corpus = build_corpus(engine, prompts, max_new_tokens=max_new_tokens,
                          seed=seed)
    hiddens = collect_hidden(engine, corpus)
    if head is None:
        head = MedusaDraftHead.fresh(cfg.hidden_size, cfg.vocab_size,
                                     num_heads=num_heads, seed=seed)
    X, Y = make_dataset(corpus, hiddens, head.num_heads)
    losses = train(head, X, Y, steps=steps, lr=lr, seed=seed)
    return head, losses


# ------------------------------------------------------------------- CLI --
def main(argv=None) -> int:
    """Distill draft heads against a checkpoint's model (``--checkpoint``: an
    HF or serialize directory, through ``engine_factory.build_hf_engine``)
    or the built-in tiny model (a self-contained demo of the
    corpus→hidden→train loop)."""
    p = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.inference.v2.spec.distill",
        description="Self-distill Medusa-style draft heads from a target model "
                    "(corpus generated in-process; no external data).")
    p.add_argument("--checkpoint", help="HF or DS-serialized checkpoint dir (default: tiny built-in fixture model)")
    p.add_argument("--out", required=True, help="output .npz for the trained heads")
    p.add_argument("--heads", type=int, default=3)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--max-new-tokens", type=int, default=48)
    p.add_argument("--num-prompts", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine, build_hf_engine
    from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import (AllocationMode, DSStateManagerConfig,
                                                                         MemoryConfig)
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_params
    from deepspeed_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.checkpoint:
        engine = build_hf_engine(args.checkpoint, device=device)
    else:
        cfg = LlamaConfig.tiny(dtype=torch.float32)
        params = init_params(cfg, torch.Generator().manual_seed(args.seed), device="cpu")
        mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode=AllocationMode.ALLOCATE, size=64),
                                   max_context=512)
        engine = build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16),
                              device=device)

    head, losses = self_distill(engine, num_heads=args.heads, steps=args.steps,
                                lr=args.lr, max_new_tokens=args.max_new_tokens,
                                num_prompts=args.num_prompts,
                                prompt_len=args.prompt_len, seed=args.seed)
    head.save(args.out)
    print(f"# spec_train: head_id={head.head_id} heads={head.num_heads} "
          f"steps={len(losses)}")
    print(f"# spec_train: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"# spec_train: saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
