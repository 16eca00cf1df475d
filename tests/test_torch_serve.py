"""Parity of the port's batched decode server with the JAX package's.

With the JAX defaults (12 requests, 4 slots, cache 256, seed 0) and the
same parameters carried across, in float32 compute, both servers must
emit the same tokens for every request, take the same number of decode
steps and finish the same requests: greedy argmax leaves no tolerance.
The reference's quirks are kept on purpose (prefill by decode, one cache
position shared by all slots, writes past the cache dropped), so the
streams agree token for token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import serve as jax_serve
from repro.models.common import Policy as JaxPolicy
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_params
from repro_torch.launch import serve
from repro_torch.models.common import Policy


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-7b"])
def test_server_matches_reference_token_for_token(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    jm = JaxModel(jcfg, JaxPolicy(compute_dtype=jnp.float32))
    params, _ = jm.init_params(jax.random.key(0))
    jqueue = jax_serve.synthetic_requests(12, jcfg.vocab_size, 0)
    jreqs = list(jqueue)
    jout = jax_serve.BatchedServer(jm, params, 4, 256).run(jqueue)

    model = model_params(jax.tree.map(np.asarray, params),
                         reduced(get_config(arch)),
                         policy=Policy(compute_dtype=torch.float32),
                         device="cpu")
    queue = serve.synthetic_requests(12, model.cfg.vocab_size, 0)
    reqs = list(queue)
    for a, b in zip(reqs, jreqs):
        assert np.array_equal(a.prompt, b.prompt) and a.max_new == b.max_new
    out = serve.BatchedServer(model, 4, 256).run(queue)

    assert out["decode_steps"] == jout["decode_steps"]
    assert out["requests_done"] == jout["requests_done"] == 12
    assert out["tokens_out"] == jout["tokens_out"]
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert all(r.done for r in reqs)


def test_main_runs_the_reduced_server_on_the_cpu(capsys):
    assert serve.main(["--arch", "rwkv6-7b", "--requests", "3",
                       "--slots", "2", "--cache-len", "128",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] rwkv6-7b" in out and "3 done" in out


def test_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: asking for it is legitimate here")
    with pytest.raises(RuntimeError):
        serve.main(["--requests", "1"])
