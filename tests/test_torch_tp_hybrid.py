"""The port's tensor parallelism over "model" for the hybrid family
(recurrentgemma), in four gloo ranks on the CPU, against the JAX package.

One subprocess runs the reference (``tests/torch_tp_workers.py``, suite
"hybrid": four forced CPU devices, its meshes from
``repro.launch.mesh._make_mesh``) and one spawn of four gloo ranks runs the
port (float32, reduced recurrentgemma-9b at 5 layers: a (rec, rec, attn)
unit and a (rec, rec) tail, d 128, LRU width 128, 4 query heads over 1 KV
head of 32, window 64; one batch of 4 x 128 tokens, so the attention runs
in its window). Cases (``torch_tp_workers.HYBRID``): (2, 2) (each "model"
group a (1, 2) run: 2 query heads and 64 LRU channels a rank), (1, 4) (1
head, 32 channels) and 6 query heads at (1, 4), which do not divide 4
while the window does: the windowed attention's query rows split over
"model" (the reference's ``_seq_shard_fallback``). The RG-LRU's weights
stay whole on every rank (the reference's "lru" axis has no rule); each
rank computes its slice of the width. The one KV head stays whole, and so
does the ring of the decode cache.

Limits, ``tests/test_torch_tp.py``'s: ``train_loss`` within 1e-5
(relative) of the reference's unsharded loss; each rank's gradient of
each parameter (its slice) within 1e-4 of the leaf's largest magnitude
of the unsharded run's; the prefill's logits and every cache tensor
gathered into the reference's layout (``convert.whole_cache``: ``h`` and
``conv`` the rank's width) within 1e-4 elementwise; the decode step
after the prefill and three steps from a seeded cache within 1e-4; the
``BatchedServer``'s tokens equal. A mutant whose ``dist.split_dim`` does
not gather ``wx``'s gradient leaves each rank its own channels' share,
and two ``Trainer`` steps at (2, 2) (4 x 128 tokens) meet the
single-process port step by step at ``tests/test_torch_dist_train.py``'s
limits (``torch_tp_workers.check_trainer``).
"""
import json

import pytest

import torch_tp_workers as workers

SUITE = "hybrid"
CASES = tuple(workers.HYBRID)
RUN = next(iter(workers.FAMILY_TRAIN[SUITE]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_hybrid")
    workers.run_suite(SUITE, str(out))
    return out


@pytest.mark.parametrize("case", CASES)
def test_train_loss_and_grads_match_reference(run, case):
    workers.check_loss_and_grads(run, case)


@pytest.mark.parametrize("case", CASES)
def test_prefill_logits_and_gathered_caches_match_reference(run, case):
    workers.check_prefill(run, case)


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_reference(run, case):
    workers.check_decode(run, case)


@pytest.mark.parametrize("case", CASES)
def test_server_tokens_match_reference(run, case):
    workers.check_server(run, case)


def test_layouts_of_the_cases(run):
    """The rank's query heads where "model" divides them, its rows of the
    window otherwise; the KV head and the RG-LRU's weights whole, its width
    split, in every case."""
    for case, heads in (("recurrentgemma-9b@2x2", True),
                        ("recurrentgemma-9b@1x4", True),
                        ("recurrentgemma-9b-h6@1x4", False)):
        for _, facts in workers.ranks_of(run, case):
            assert facts["layout"] == {"heads_local": heads,
                                       "kv_local": False, "rec_split": True}
            assert facts["kv_shards"] is None
            split = facts["tp_dims"]
            assert ("units.0.l2_attn.attn.wq" in split) == heads
            assert "units.0.l2_attn.attn.wk" not in split
            assert not any(".rec." in name for name in split)
            assert split["tail.0.mlp.wo"] == 0 and split["embed.tok"] == 0


def test_partly_used_replicated_leaf_gets_whole_gradient(run):
    workers.check_mutant(run, SUITE)


def test_trainer_steps_at_2x2_match_single_process(run):
    facts = [json.loads((run / f"train_rank{r}.json").read_text())
             for r in range(4)]
    workers.check_trainer(run, facts, RUN)
