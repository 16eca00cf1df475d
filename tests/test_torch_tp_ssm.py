"""The port's tensor parallelism over "model" for the ssm family (rwkv6), in
four gloo ranks on the CPU, against the JAX package.

One subprocess runs the reference (``tests/torch_tp_workers.py``, suite
"ssm": four forced CPU devices, its meshes from
``repro.launch.mesh._make_mesh``) and one spawn of four gloo ranks runs the
port (float32, reduced rwkv6-7b: 2 layers, d 128, 4 heads of 32, d_ff
256, vocab 512; one batch of 4 x 32 tokens). Cases
(``torch_tp_workers.SSM``): (2, 2) (the port's plain calls do not split
the batch over "data", so each "model" group is a (1, 2) run: 2 heads a
rank), (1, 4) (1 head a rank) and d 96 at (1, 4) (3 heads do not divide
4: the time mix computes whole on every rank, as the reference's
divisibility fallback replicates it; the channel mix's ff still splits).

Limits, ``tests/test_torch_tp.py``'s: ``train_loss`` within 1e-5
(relative) of the reference's unsharded loss (the (2, 2) case also of
its (2, 2) run's); each rank's gradient of each parameter (its slice)
within 1e-4 of the leaf's largest magnitude; the prefill's logits and
every cache tensor gathered into the reference's layout
(``convert.whole_cache``: ``wkv`` the rank's heads) within 1e-4
elementwise; the decode step after the prefill and three steps from a
seeded cache (each rank's slice of one N(0, 0.5^2) cache both packages
read) within 1e-4; the ``BatchedServer``'s tokens equal. The gradients
of the (2, 2) case are held to the reference's own (2, 2) run, which
splits the batch over "data", so its float32 sums for the bonus ``u``
run in another order than its unsharded run's (ROADMAP queue 3); the
other cases to the unsharded run. A mutant whose
``dist.split_dim`` does not gather ``ln_x_s``'s gradient leaves each
rank its own heads' share.

Two ``Trainer`` steps at (2, 2) are held to the single-process port
(``torch_tp_workers.check_trainer``): the losses and gradient norms of
both steps within 1e-5, and the state after step 1 (the same start) at
``tests/test_torch_dist_train.py``'s limits. The state after step 2 is
not held: it misses them, and what moves it is tensor parallelism's
float32 order, not a fault (``tools/tp_trainer_noise.py``): after step 1 the
moments lie within 3.0e-5 (2, 2) and 3.1e-5 (1, 4) of each leaf's
largest magnitude (the bonus ``u``), but step 2 from the same state lies
1.9e-4 (2, 2) and 8.1e-5 (1, 4) away (``nu`` of layer 1's ``wr``), a
pure "data" (4, 1) run 8.7e-7. At the step-1 states layer 1's group norm
sees a head whose input variance is 4.7e-5, under five times its eps,
and its slope amplifies rounding: plain ``train_loss`` gradients (no
Trainer) at (1, 4) lie up to 2.2e-5 from the single process's at its
own step-1 state and up to 7.0e-5 at the (2, 2) run's. The hybrid and
audio files hold step 2 too.
"""
import json

import pytest

import torch_tp_workers as workers

SUITE = "ssm"
CASES = tuple(workers.SSM)
RUN = next(iter(workers.FAMILY_TRAIN[SUITE]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_ssm")
    workers.run_suite(SUITE, str(out))
    return out


@pytest.mark.parametrize("case", CASES)
def test_train_loss_and_grads_match_reference(run, case):
    workers.check_loss_and_grads(
        run, case, "mesh2x2" if case == "rwkv6-7b@2x2" else "plain")


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
    """The time mix on the rank's heads where "model" divides them, whole
    at d 96; the channel mix's ff split in every case."""
    for case, heads in (("rwkv6-7b@2x2", True), ("rwkv6-7b@1x4", True),
                        ("rwkv6-7b-d96@1x4", False)):
        for _, facts in workers.ranks_of(run, case):
            assert facts["layout"] == {"tm_split": heads, "cm_split": True}
            split = facts["tp_dims"]
            assert ("layers.0.tm.wr" in split) == heads
            assert ("layers.0.tm.u" in split) == heads
            assert split["layers.0.cm.wk"] == 1
            assert split["layers.0.cm.wv"] == 0
            assert "layers.0.tm.ln_x_s" not in split


def test_partly_used_replicated_leaf_gets_whole_gradient(run):
    workers.check_mutant(run, SUITE)


def test_trainer_steps_at_2x2_match_single_process(run):
    facts = [json.loads((run / f"train_rank{r}.json").read_text())
             for r in range(4)]
    workers.check_trainer(run, facts, RUN, step2=False)
