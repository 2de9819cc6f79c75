"""The port's ``BatchServer`` on the CPU: the scenarios of
``test_serve_engine.py`` (wave batching and stats; slot isolation), each
emitting exactly the reference server's tokens for the same requests on
the same (carried) parameters; EOS masking; the stub frontends; and the
``max_len`` refusal at ``submit`` (a known difference: the reference's
clamped cache writes run such a request)."""
import numpy as np
import jax
import pytest
import torch

from repro.configs import base as RB
from repro.models import api as RA
from repro.serve import engine as RE
from repro_torch.configs.base import smoke_config
from repro_torch.launch import serve as TLS
from repro_torch.models import api as TA
from repro_torch.serve.engine import BatchServer, Completion, Request


def carried(arch):
    cfg = smoke_config(arch)
    rparams = RA.init(jax.random.PRNGKey(0), RB.smoke_config(arch))
    return cfg, rparams, TA.from_numpy(rparams, cfg, device="cpu")


@pytest.fixture(scope="module")
def qwen2():
    return carried("qwen2-0.5b")


def serve(server, requests):
    for r in requests:
        server.submit(r)
    return server.run()


def both(cfg, rparams, params, requests, **kw):
    """(port completions, reference completions) for the same requests."""
    mine = serve(BatchServer(cfg, params, device="cpu", **kw),
                 [Request(r.rid, list(r.prompt), r.max_new)
                  for r in requests])
    theirs = serve(RE.BatchServer(RB.smoke_config(cfg.name), rparams, **kw),
                   [RE.Request(r.rid, list(r.prompt), r.max_new)
                    for r in requests])
    return mine, theirs


def tokens(out) -> dict:
    return {rid: c.tokens for rid, c in out.items()}


def wave_requests(cfg):
    rng = np.random.default_rng(0)
    reqs = [Request(rid, rng.integers(0, cfg.vocab_size, 8).tolist(),
                    max_new=6) for rid in range(4)]
    reqs += [Request(rid, rng.integers(0, cfg.vocab_size, 12).tolist(),
                     max_new=4) for rid in range(4, 6)]
    return reqs


def test_wave_batching_and_results(qwen2):
    """Two length buckets, 6 requests at max_batch=4 -> 2 waves; every
    request its max_new tokens, the reference's tokens exactly."""
    cfg, rparams, params = qwen2
    out, ref = both(cfg, rparams, params, wave_requests(cfg), max_batch=4)
    assert set(out) == set(range(6))
    assert all(isinstance(c, Completion) for c in out.values())
    for rid in range(4):
        assert len(out[rid].tokens) == 6
    for rid in range(4, 6):
        assert len(out[rid].tokens) == 4
    assert tokens(out) == tokens(ref)


def test_wave_stats(qwen2):
    cfg, _, params = qwen2
    srv = BatchServer(cfg, params, max_batch=4, device="cpu")
    serve(srv, wave_requests(cfg))
    assert srv.stats["waves"] == 2
    assert srv.stats["tokens"] == 4 * 6 + 2 * 4
    assert srv.stats["occupancy"] == [1.0, 0.5]
    assert [(w["prompt_len"], w["requests"], w["decode_steps"])
            for w in srv.stats["wave_log"]] == [(8, 4, 5), (12, 2, 3)]
    assert srv.queue == []


def test_results_match_unbatched_decode():
    """A request served in a padded wave produces the same tokens as the
    same prompt decoded alone (slot isolation), and the reference's."""
    cfg, rparams, params = carried("qwen2.5-3b")
    prompt = list(range(10, 18))
    solo, ref_solo = both(cfg, rparams, params, [Request(0, prompt, 5)],
                          max_batch=1)
    rng = np.random.default_rng(1)
    reqs = [Request(0, prompt, 5)] + [
        Request(rid, rng.integers(0, cfg.vocab_size, len(prompt)).tolist(),
                5) for rid in (1, 2)]
    waved, ref_waved = both(cfg, rparams, params, reqs, max_batch=4)
    assert solo[0].tokens == waved[0].tokens
    assert tokens(solo) == tokens(ref_solo)
    assert tokens(waved) == tokens(ref_waved)


def test_eos_masks_a_finished_slot(qwen2):
    """With an EOS id that one request emits, that request stops at its
    first decoded EOS (the prefill's token is not checked, as in the
    reference) and every request's tokens are the reference's."""
    cfg, rparams, params = qwen2
    reqs = wave_requests(cfg)
    plain, _ = both(cfg, rparams, params, reqs, max_batch=4)
    eos = plain[0].tokens[2]
    stop = plain[0].tokens.index(eos, 1)
    out, ref = both(cfg, rparams, params, reqs, max_batch=4, eos_id=eos)
    assert out[0].tokens == plain[0].tokens[:stop + 1]
    assert len(out[0].tokens) < 6
    assert tokens(out) == tokens(ref)


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-medium",
                                  "zamba2-1.2b"])
def test_stub_frontends_and_hybrid_cache_serve_the_references_tokens(arch):
    """Zero patch embeddings (vlm), zero frames (audio) and the hybrid's
    shared-attention slots: the reference's tokens."""
    cfg, rparams, params = carried(arch)
    rng = np.random.default_rng(2)
    reqs = [Request(rid, rng.integers(0, cfg.vocab_size, 9).tolist(), 4)
            for rid in range(3)]
    out, ref = both(cfg, rparams, params, reqs, max_batch=2)
    assert tokens(out) == tokens(ref)


def test_submit_refuses_a_request_past_max_len(qwen2):
    """A prompt of P and N new tokens write P + N - 1 cache positions.
    At max_len = P + N - 1 the request runs and gives the reference's
    tokens; one more new token is refused at submit, where the reference
    runs it (its cache writes clamp at the last position)."""
    cfg, rparams, params = qwen2
    prompt = list(range(20, 30))
    fits = [Request(0, prompt, 6)]
    out, ref = both(cfg, rparams, params, fits, max_batch=2, max_len=15)
    assert len(out[0].tokens) == 6 and tokens(out) == tokens(ref)

    srv = BatchServer(cfg, params, max_batch=2, max_len=15, device="cpu")
    with pytest.raises(ValueError, match="max_len 15"):
        srv.submit(Request(1, prompt, 7))
    assert srv.queue == []
    ref_srv = RE.BatchServer(RB.smoke_config(cfg.name), rparams,
                             max_batch=2, max_len=15)
    ref_srv.submit(RE.Request(1, prompt, 7))
    assert len(ref_srv.run()[1].tokens) == 7


def test_ssm_has_no_positional_cache_to_outgrow():
    """mamba2's state has no positions: a request past max_len is served,
    with the reference's tokens."""
    cfg, rparams, params = carried("mamba2-2.7b")
    reqs = [Request(0, list(range(5, 15)), 8)]
    out, ref = both(cfg, rparams, params, reqs, max_batch=1, max_len=12)
    assert len(out[0].tokens) == 8 and tokens(out) == tokens(ref)


def test_server_refuses_params_on_another_device(qwen2):
    cfg, _, params = qwen2
    with pytest.raises(ValueError, match="params on cpu"):
        BatchServer(cfg, params, device="meta")


def test_launch_serve_on_the_cpu():
    """``python -m repro_torch.launch.serve --smoke --device cpu``: a
    batch of prompts prefilled, then greedy tokens, the same each run."""
    argv = ["--arch", "whisper-medium", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "5", "--gen", "4"]
    first = TLS.main(argv)
    assert tuple(first["tokens"].shape) == (2, 4)
    assert bool((first["tokens"] >= 0).all())
    assert bool((first["tokens"] < smoke_config("whisper-medium").vocab_size)
                .all())
    assert torch.equal(TLS.main(argv)["tokens"], first["tokens"])
