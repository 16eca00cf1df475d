"""The port's tensor parallelism over "model" for the audio family
(whisper), in four gloo ranks on the CPU, against the JAX package.

One subprocess runs the reference (``tests/torch_tp_workers.py``, suite
"audio": four forced CPU devices, its meshes from
``repro.launch.mesh._make_mesh``) and one spawn of four gloo ranks runs the
port (float32, reduced whisper-small: 2 encoder and 2 decoder layers, d
128, 4 heads over 2 KV heads of 32, 16 seeded frames, vocab 512; one
batch of 4 x 32 tokens). Cases (``torch_tp_workers.AUDIO``): (2, 2) (each
"model" group a (1, 2) run: 2 query and 1 KV head a rank, the cross
caches the rank's KV head), (1, 4) (1 query head a rank; the 2 KV heads
do not divide 4, so every rank projects both and attends with its query
head's, and the cross caches hold both), and 6 heads over 6 at (1, 4):
the encoder's, the decoder's and the cross attention's query rows split
over "model" (the reference's ``_seq_shard_fallback``). The decoder's
self-attention cache is the rank's sequence slice (flash-decode) in every
case.

Limits, ``tests/test_torch_tp.py``'s: ``train_loss`` within 1e-5
(relative) of the reference's unsharded loss; each rank's gradient of
each parameter (its slice) within 1e-4 of the leaf's largest magnitude
of the unsharded run's; the prefill's logits and the four caches
gathered into the reference's layout (``convert.whole_cache``) within
1e-4 elementwise; the decode step after the prefill and three steps from
a seeded cache (cross caches included) within 1e-4; the
``BatchedServer``'s tokens equal (its cross caches are the zeros of
``init_cache``, as the reference's). A mutant whose ``dist.copy_in``
does not sum the gradients leaves each rank its own query head's share
of the cross attention's replicated ``wk``, and two ``Trainer`` steps at
(2, 2) meet the single-process port step by step at
``tests/test_torch_dist_train.py``'s limits
(``torch_tp_workers.check_trainer``).
"""
import json

import pytest

import torch_tp_workers as workers

SUITE = "audio"
CASES = tuple(workers.AUDIO)
RUN = next(iter(workers.FAMILY_TRAIN[SUITE]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_audio")
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
    """Heads and KV heads (self and cross) split where "model" divides
    them; the query rows with 6 heads; the self cache sequence-sharded."""
    for case, heads, kv in (("whisper-small@2x2", True, True),
                            ("whisper-small@1x4", True, False),
                            ("whisper-small-h6@1x4", False, False)):
        for _, facts in workers.ranks_of(run, case):
            assert facts["layout"] == {"heads_local": heads, "kv_local": kv,
                                       "cross_kv_local": kv}
            assert facts["kv_shards"] == facts["tp"]
            assert facts["decode_kv_shards"] == facts["tp"]
            split = facts["tp_dims"]
            for att in ("enc_layers.0.attn", "dec_layers.0.attn",
                        "dec_layers.0.cross"):
                assert (f"{att}.wq" in split) == heads
                assert (f"{att}.wk" in split) == kv
            assert split["enc_layers.0.mlp.wo"] == 0


def test_partly_used_replicated_leaf_gets_whole_gradient(run):
    workers.check_mutant(run, SUITE)


def test_trainer_steps_at_2x2_match_single_process(run):
    facts = [json.loads((run / f"train_rank{r}.json").read_text())
             for r in range(4)]
    workers.check_trainer(run, facts, RUN)
