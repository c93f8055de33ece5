"""Port parity: the learned drafter under the serving scheduler.

Side by side, as ``tests/test_torch_spec_serving.py`` (whose helpers this
file uses): the JAX ``ServingScheduler`` over the JAX engine and the port's
over the port's get the same weights, the same draft heads and the same
submits, stepped by hand, for the learned drafter (token trees) and
``auto``. The rest mirrors ``tests/unit/serving/test_spec_learned.py`` on
the port: brownout, the learned drafter's state across a handoff,
self-distillation, acceptance against prompt lookup and the drafter pin.
These cases run on the reference's permutation-walk fixture (attention and
MLP outputs zeroed, the lm_head rewritten so that greedy decoding walks one
256-cycle), where prompt lookup can never match and distilled heads draft
perfectly.
"""

import copy

import jax
import numpy as np
import pytest

from deepspeed_tpu_torch.inference.v2.spec.distill import self_distill
from deepspeed_tpu_torch.inference.v2.spec.learned import MedusaDraftHead
from deepspeed_tpu_torch.serving import ServingConfig, ServingScheduler, SpeculativeConfig
from tests.test_torch_serving import _run_until, clear_jax_caches, fresh_telemetry, make_engine, setup  # noqa: F401
from tests.test_torch_spec_serving import REPEAT, _engine, _frame_header, _side_by_side, _spec_config, _submit
from tests.torch_port_helpers import port_params


# ---------------------------------------------------------------- fixtures --
@pytest.fixture(scope="module")
def perm_setup(setup):
    """(jcfg, jparams, port params, order, perm): the permutation-walk model.
    With attention and MLP outputs zeroed, position t's residual is
    embed(tok_t), and the rewritten lm_head makes perm[current] the greedy
    argmax by a wide margin."""
    jcfg, jparams, _, _ = setup
    m = copy.deepcopy(jax.tree.map(np.asarray, jparams)["model"])
    for name, layer in m.items():
        if name.startswith("layers_"):
            layer["self_attn"]["o_proj"]["kernel"] = np.zeros_like(layer["self_attn"]["o_proj"]["kernel"])
            layer["mlp"]["down_proj"]["kernel"] = np.zeros_like(layer["mlp"]["down_proj"]["kernel"])
    rng = np.random.default_rng(5)
    V, H = jcfg.vocab_size, jcfg.hidden_size
    order = rng.permutation(V)  # one V-cycle: every walked token is distinct
    perm = np.empty(V, np.int64)
    perm[order] = np.roll(order, -1)
    emb = m["embed_tokens"]["embedding"]
    hn = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    W = np.zeros((H, V), np.float32)
    W[:, perm] = hn.T * 8.0
    m["lm_head"]["kernel"] = W
    jp = {"model": m}
    return jcfg, jp, port_params(jcfg, jp), order, perm


@pytest.fixture(scope="module")
def distilled(perm_setup, tmp_path_factory):
    """Draft heads self-distilled by the port from the permutation model's own
    greedy generations, once for the module: (path, loss trace)."""
    engine = _engine("port", perm_setup)
    try:
        order = perm_setup[3]
        prompts = [[int(t) for t in order[i * 32:i * 32 + 8]] for i in range(6)]
        head, losses = self_distill(engine, prompts=prompts, num_heads=3, max_new_tokens=40, steps=400, lr=5e-3,
                                    seed=0)
    finally:
        engine.close()
    path = tmp_path_factory.mktemp("spec_heads") / "perm_heads.npz"
    head.save(str(path))
    return str(path), losses


def _cycle_prompt(order, start=100, n=8):
    return [int(t) for t in order[start:start + n]]



# ------------------------------------------------------------- side by side --
LEARNED_SCENARIOS = {
    "learned_greedy": (dict(drafter="learned"), dict(max_new_tokens=16)),
    "learned_sampled": (dict(drafter="learned"), dict(max_new_tokens=12, temperature=0.8, seed=77)),
    "auto_greedy": (dict(drafter="auto"), dict(max_new_tokens=20)),
    "auto_pinned_lookup": (dict(drafter="auto"), dict(max_new_tokens=10, drafter="prompt_lookup")),
}


@pytest.mark.parametrize("name", list(LEARNED_SCENARIOS))
def test_side_by_side_learned_and_auto(perm_setup, distilled, name):
    spec_kw, submit_kw = LEARNED_SCENARIOS[name]
    path, _ = distilled
    prompt = _cycle_prompt(perm_setup[3])
    config = {"speculative": dict(enabled=True, max_draft_tokens=3, draft_head_path=path, **spec_kw)}
    script = [_submit(prompt, **submit_kw), ("step", 3), _submit(_cycle_prompt(perm_setup[3], 40), **submit_kw)]
    jax_run, port_run = _side_by_side(perm_setup, script, config)
    assert port_run == jax_run
    assert port_run["counters"]["spec_tree_nodes"] > 0 and port_run["tracked"] == 0


# ----------------------------------------------------------------- brownout --
def _force_stage(sched, stage):
    """Drive the brownout controller to ``stage`` and pin it there."""
    thresholds = sched._brownout._thresholds
    target = 1.0 if stage >= len(thresholds) else ((thresholds[stage - 1] + thresholds[stage]) / 2 if stage else 0.0)
    for _ in range(60):
        sched._brownout.update(target)
    assert sched._brownout.stage == stage
    sched._brownout.update = lambda pressure: stage


def test_brownout_stage2_zeroes_the_draft_budget(make_engine, perm_setup, distilled):
    """Stage 2 stops drafting, linear and tree, without touching a request's
    max_new_tokens; degraded, not different."""
    lookup = ServingScheduler(make_engine(), _spec_config(k=4, prefix=False), start=False)
    tree_engine = _engine("port", perm_setup)
    tree = ServingScheduler(tree_engine, ServingConfig(speculative=SpeculativeConfig(
        enabled=True, drafter="learned", max_draft_tokens=3, draft_head_path=distilled[0])), start=False)
    try:
        for sched, prompt in ((lookup, REPEAT), (tree, _cycle_prompt(perm_setup[3]))):
            base = sched.submit(prompt, max_new_tokens=8)
            _run_until(sched, lambda: base.finished)
            assert base.spec_drafted > 0  # stage 0: speculation on
            assert sched is lookup or base.spec_accepted > 0
            nodes = sched._counters["spec_tree_nodes"]
            _force_stage(sched, 2)
            req = sched.submit(prompt, max_new_tokens=8)
            assert "speculative_disabled" in req.degraded_mode and req.max_new_tokens == 8
            _run_until(sched, lambda: req.finished)
            assert req.spec_drafted == 0 and req.decode_steps == 7  # one token a dispatch again
            assert req.tokens == base.tokens
            assert sched._counters["spec_tree_nodes"] == nodes
    finally:
        lookup.stop(drain=False)
        tree.stop(drain=False)
        tree_engine.close()


# ------------------------------------------------------------------ handoff --
def test_handoff_preserves_learned_drafter_state_and_drops_a_foreign_heads(perm_setup, distilled, tmp_path):
    """Between two schedulers with the same head the per-drafter EWMAs and the
    head id ride the frame; a recipient with another head drops only the
    learned EWMA. Both continuations equal the request served whole."""
    jcfg = perm_setup[0]
    path, _ = distilled
    other = tmp_path / "other_heads.npz"
    MedusaDraftHead.fresh(jcfg.hidden_size, jcfg.vocab_size, num_heads=3, seed=9).save(str(other))
    prompt = _cycle_prompt(perm_setup[3])
    cfg = lambda p: ServingConfig(speculative=SpeculativeConfig(enabled=True, drafter="auto", max_draft_tokens=3,
                                                                draft_head_path=p))
    engines = [_engine("port", perm_setup) for _ in range(4)]
    try:
        whole_s = ServingScheduler(engines[0], ServingConfig(), start=False)
        whole = whole_s.submit(prompt, max_new_tokens=16)
        _run_until(whole_s, lambda: whole.finished)
        whole_s.stop(drain=False)
        donor = ServingScheduler(engines[1], cfg(path), start=False)
        head = donor.submit(prompt, max_new_tokens=8, handoff=True)
        _run_until(donor, lambda: head.finished)
        donor.stop(drain=False)
        assert head.spec_accepted > 0 and head._spec_ewmas.get("learned") is not None
        assert _frame_header(head.handoff_payload)["extra"]["spec"]["head_id"] == MedusaDraftHead.load(path).head_id
        for engine, heads_path, keeps_learned in ((engines[2], path, True), (engines[3], str(other), False)):
            recipient = ServingScheduler(engine, cfg(heads_path), start=False)
            tail = recipient.submit_resume(head.handoff_payload, max_new_tokens=8)
            want = {k: v for k, v in head._spec_ewmas.items() if v is not None and (keeps_learned or k != "learned")}
            assert tail._spec_ewmas == want and tail.spec_accepted == head.spec_accepted
            _run_until(recipient, lambda: tail.finished)
            assert head.result() + tail.result() == whole.result()
            recipient.stop(drain=False)
    finally:
        for engine in engines:
            engine.close()


# ------------------------------------------------------------ learned drafter --
def test_self_distill_learns_the_permutation(perm_setup, distilled):
    """The loss trace collapses, and the saved heads predict perm^(2+h) from
    the hidden state of token v, embed(v)."""
    jcfg, jparams, _, _, perm = perm_setup
    path, losses = distilled
    assert losses[-1] < losses[0] and losses[-1] < 0.1
    head = MedusaDraftHead.load(path)
    lp = head.head_log_probs(jparams["model"]["embed_tokens"]["embedding"].astype(np.float32))
    for h in range(head.num_heads):
        targ = np.arange(jcfg.vocab_size)
        for _ in range(2 + h):
            targ = perm[targ]
        assert (np.argmax(lp[h], axis=-1) == targ).mean() > 0.5


def test_learned_acceptance_strictly_beats_prompt_lookup(perm_setup, distilled):
    """On the cycle walk prompt lookup accepts nothing and pays a dispatch a
    token; the learned heads land the same tokens in strictly fewer
    dispatches at more than one token a step; greedy and sampled output
    equals spec-off, cold and warm."""
    prompt = _cycle_prompt(perm_setup[3])
    engines = []

    def run(cfg, n=20, **kw):
        engines.append(_engine("port", perm_setup))
        sched = ServingScheduler(engines[-1], cfg, start=False)
        try:
            reqs = [sched.submit(prompt, max_new_tokens=n, **kw) for _ in range(2)]  # cold, then beside it
            _run_until(sched, lambda: all(r.finished for r in reqs))
        finally:
            sched.stop(drain=False)
        assert engines[-1].free_blocks == 64
        return reqs[0]

    learned_cfg = ServingConfig(speculative=SpeculativeConfig(enabled=True, drafter="learned", max_draft_tokens=3,
                                                              draft_head_path=distilled[0]))
    try:
        off = run(ServingConfig())
        lookup = run(ServingConfig(speculative=SpeculativeConfig(enabled=True, max_draft_tokens=3)))
        learned = run(learned_cfg)
        assert off.result() == lookup.result() == learned.result()
        assert lookup.spec_accepted == 0 < learned.spec_accepted
        assert learned.decode_steps < lookup.decode_steps
        assert len(learned.tokens) / learned.decode_steps > 1.0
        sampled = dict(n=12, temperature=0.8, seed=77)
        assert run(learned_cfg, **sampled).result() == run(ServingConfig(), **sampled).result()
    finally:
        for engine in engines:
            engine.close()


def test_auto_arbitration_and_drafter_pins(perm_setup, distilled):
    """auto races both drafters and settles on the learned heads without
    changing the tokens; a learned pin never explores prompt lookup, an
    unknown pin fails at submit; the stats document names each drafter."""
    prompt = _cycle_prompt(perm_setup[3])
    engine = _engine("port", perm_setup)
    sched = ServingScheduler(engine, ServingConfig(speculative=SpeculativeConfig(
        enabled=True, drafter="auto", max_draft_tokens=3, draft_head_path=distilled[0])), start=False)
    try:
        with pytest.raises(ValueError):
            sched.submit(prompt, max_new_tokens=4, drafter="medusa")
        free = sched.submit(prompt, max_new_tokens=20)
        _run_until(sched, lambda: free.finished)
        assert free._spec_ewmas["learned"] > free._spec_ewmas["prompt_lookup"] and free.spec_accepted > 0
        assert sched._counters["spec_drafter_switches"] >= 1
        pinned = sched.submit(prompt, max_new_tokens=20, drafter="learned")
        _run_until(sched, lambda: pinned.finished)
        assert pinned._spec_last_drafter == "learned" and "prompt_lookup" not in pinned._spec_ewmas
        assert pinned.result() == free.result()
        doc = sched.stats()["speculative"]
        assert doc["drafter"] == "auto" and doc["head_id"] == MedusaDraftHead.load(distilled[0]).head_id
        assert doc["drafters"]["learned"]["accepted"] > 0 and doc["tree"]["nodes"] > 0
    finally:
        sched.stop(drain=False)
        engine.close()
