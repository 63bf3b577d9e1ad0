"""The port's LM ``Server`` against the JAX package's, on the CPU.

Both servers answer the same mixed-length batch with the same parameters
(drawn in numpy, carried to the port with ``convert.params_from_numpy``)
and must give the same tokens; at the first token that differs, if any,
the top-2 logit margin must lie within the decode tolerance (1e-2 of max
|logit|), and nothing after it is compared.  Every family serves: the dense and
VLM configs, MoE (dbrx, arctic's residual MLP), xLSTM (its states
spliced), the Zamba2 hybrid (its Mamba-2 states and grouped kv spliced)
and Whisper (its cross keys and values spliced).  The admission path
mirrors ``tests/test_faults_serving.py``'s LM cases, and the reference
behaviours the port keeps are pinned: unmasked left padding (an SSM's
prefill state runs over the pads too), one discarded decode call per
batch, the f32 prefill cache cast into the bf16 decode cache.
"""

import dataclasses


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from jax_lm_helpers import numpy_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime.serve_loop import Request, Server  # noqa: E402
from repro_torch.runtime.serving import (  # noqa: E402
    InvalidRequestError,
    QueueFullError,
)

MARGIN_TOL = 1e-2


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _requests(vocab, n=8, new=10, seed=0):
    """Prompts of 4-16 tokens drawn as ``launch/serve.py`` draws them."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        plen = int(rng.randint(4, 17))
        out.append(([int(t) for t in rng.randint(0, vocab, plen)], new))
    return out


def compare_tokens(got, want, logits, tol=MARGIN_TOL):
    """Equal token lists, up to a first divergence allowed only where the
    top-2 margin of the reference's logits that chose ``want``
    (``logits[step]`` [B, V]) lies within ``tol`` of max |logit|.
    Returns the step of the first divergence, or None."""
    steps = max(len(w) for w in want)
    for step in range(steps):
        rows = [i for i, (g, w) in enumerate(zip(got, want))
                if step < len(w) and g[step] != w[step]]
        if not rows:
            continue
        for i in rows:
            row = logits[step][i]
            top2 = torch.topk(row, 2).values
            margin = float(top2[0] - top2[1])
            assert margin <= tol * float(row.abs().max()), (step, i, margin)
        return step
    assert [len(g) for g in got] == [len(w) for w in want]
    return None


def record_logits(monkeypatch, module=T):
    """Every ``module.forward`` call's last-position logits, in order
    (prefill first, then each decode call).  For the JAX package the
    forward runs inside the server's jitted steps, so an ordered
    ``jax.debug.callback`` hands each call's logits out as it runs; the
    logits and the tokens taken from them are computed as before."""
    seen = []
    real = module.forward

    def keep(last):
        seen.append(torch.from_numpy(np.array(last, np.float32)))

    def forward(*args, **kw):
        logits, cache = real(*args, **kw)
        if module is T:
            keep(logits[:, -1].float())
        else:
            jax.debug.callback(keep, logits[:, -1], ordered=True)
        return logits, cache
    monkeypatch.setattr(module, "forward", forward)
    return seen


@pytest.fixture(scope="module")
def lm():
    models = {}

    def get(arch):
        if arch not in models:
            jcfg = jax_config(arch).reduced()
            tree_np = numpy_params(jcfg, seed=3)
            models[arch] = (
                params_from_numpy(tree_np, "cpu",
                                  cfg=get_config(arch).reduced()),
                get_config(arch).reduced(),
                jax.tree_util.tree_map(jnp.asarray, tree_np), jcfg)
        return models[arch]
    return get


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen2_vl_2b",
                                  "dbrx_132b", "arctic_480b", "xlstm_350m",
                                  "zamba2_2_7b", "whisper_tiny"])
def test_server_matches_the_jax_server(lm, arch, monkeypatch):
    params, cfg, jparams, jcfg = lm(arch)
    reqs = _requests(cfg.vocab)
    server = Server(params, cfg, max_batch=8, max_len=64, device="cpu")
    jsrv = jserve.Server(jparams, jcfg, max_batch=8, max_len=64)
    for prompt, new in reqs:
        server.submit(Request(prompt=prompt, max_new_tokens=new))
        jsrv.submit(jserve.Request(prompt=prompt, max_new_tokens=new))
    seen, jseen = record_logits(monkeypatch), record_logits(monkeypatch, JT)
    got = server.step()
    want = jsrv.step()
    calls = 1 + max(n for _, n in reqs)                 # prefill + decodes
    assert len(seen) == len(jseen) == calls
    # at these seeds no reference margin is near a tie: every token agrees
    assert compare_tokens(got, want, jseen) is None
    assert server.step() == [] and jsrv.step() == []


@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_assigned_config_serves(arch):
    """Every LM config of the reference serves through the port's
    ``Server`` at its reduced size: a mixed-length batch, each request's
    tokens in the vocabulary, and a second batch served the same."""
    cfg = get_config(arch).reduced()
    params = ST.real_params(cfg, torch.Generator().manual_seed(1), "cpu")
    server = Server(params, cfg, max_batch=4, max_len=32, device="cpu")
    outs = []
    for _ in range(2):
        for prompt, new in _requests(cfg.vocab, n=3, new=5, seed=2):
            server.submit(Request(prompt=prompt, max_new_tokens=new))
        outs.append(server.step())
    assert outs[0] == outs[1]
    assert [len(o) for o in outs[0]] == [5] * 3
    assert all(0 <= t < cfg.vocab for o in outs[0] for t in o)


def test_compare_tokens_stops_at_a_tie_and_refuses_a_clear_flip():
    logits = [torch.tensor([[1.0, 0.999, -1.0], [2.0, 0.0, 0.0]])] * 3
    assert compare_tokens([[0, 5], [0, 0]], [[1, 7], [0, 0]], logits) == 0
    with pytest.raises(AssertionError):
        compare_tokens([[0, 0], [1, 0]], [[0, 0], [0, 0]], logits)
    assert compare_tokens([[0, 1]], [[0, 1]], logits) is None


# ---------------------------------------------------------------------------
# The reference's behaviours, pinned
# ---------------------------------------------------------------------------

def test_left_padding_is_attended_unmasked(lm):
    """A short prompt batched with a longer one is left-padded with token
    0 and attended over with no mask, positions counting from 0 across
    the pads: its prefill equals the zero-padded prompt served alone, and
    not the prompt alone."""
    params, cfg, _, _ = lm("llama3_2_1b")
    server = Server(params, cfg, device="cpu")
    short, long_ = [5, 6, 7], [9, 8, 7, 6, 5, 4, 3]
    toks, lens = server._pad_batch([Request(short), Request(long_)])
    assert lens == [3, 7] and toks[0].tolist() == [0] * 4 + short
    with torch.inference_mode():
        both, _ = server._prefill(params, {"tokens": toks})
        padded, _ = server._prefill(params, {"tokens": toks[:1].clone()})
        alone, _ = server._prefill(params,
                                   {"tokens": torch.tensor([short])})
    scale = float(padded.abs().max())
    assert float((both[0] - padded[0]).abs().max()) <= 1e-5 * scale
    assert float((both[0] - alone[0]).abs().max()) > 1e-3 * scale


def test_ssm_prefill_state_runs_over_the_left_pads(lm):
    """Kept from the reference: an xLSTM prompt batched with a longer one
    carries its recurrent state through the zero pads, so its prefill
    equals the zero-padded prompt served alone, not the prompt alone,
    and so does the state the decode continues from."""
    params, cfg, _, _ = lm("xlstm_350m")
    server = Server(params, cfg, device="cpu")
    toks, _ = server._pad_batch([Request([5, 6, 7]),
                                 Request([9, 8, 7, 6, 5, 4, 3])])
    with torch.inference_mode():
        both, st_both = server._prefill(params, {"tokens": toks})
        padded, st_pad = server._prefill(params,
                                         {"tokens": toks[:1].clone()})
        alone, _ = server._prefill(params, {"tokens": toks[:1, 4:].clone()})
    scale = float(padded.abs().max())
    assert float((both[0] - padded[0]).abs().max()) <= 1e-5 * scale
    assert float((both[0] - alone[0]).abs().max()) > 1e-3 * scale
    gla, tail = st_both["states"][1]               # an mLSTM layer's
    assert torch.allclose(gla[:1], st_pad["states"][1][0], rtol=1e-5,
                          atol=1e-6)
    assert tail.dtype == torch.float32             # the f32 prefill's


def test_splice_hands_over_states_and_cross(lm):
    """``splice`` copies the hybrid's grouped kv into the bf16 cache and
    replaces xLSTM's ``states``, the hybrid's ``ssm`` and Whisper's
    ``cross`` with the prefill's, as the reference's ``_splice`` does."""
    for arch, keys in (("xlstm_350m", ("states",)),
                       ("zamba2_2_7b", ("ssm",)),
                       ("whisper_tiny", ("cross",))):
        params, cfg, jparams, jcfg = lm(arch)
        server = Server(params, cfg, max_len=32, device="cpu")
        toks = torch.arange(2 * 6).reshape(2, 6) % cfg.vocab
        with torch.inference_mode():
            _, pc = server._prefill(params, {"tokens": toks,
                                             **server._extra_for(2, 6)})
            cache = server._splice(T.init_cache(params, cfg, 2, 32), pc, 6)
        assert cache["pos"] == 6
        for key in keys:
            assert cache[key] is pc[key]
        if "kv" in pc:
            big, small = cache["kv"][0], pc["kv"][0]
            assert big.dtype == torch.bfloat16 and big.shape[2] == 32
            assert torch.equal(big[:, :, :6], small.bfloat16())
            assert not big[:, :, 6:].any()
        jcache = JT.init_cache(jparams, jcfg, 2, 32)
        assert sorted(cache) == sorted(jcache)


def test_decode_calls_and_cache_dtypes(lm, monkeypatch):
    """``step`` makes max_new decode calls and drops the last token; the
    f32 prefill cache is cast into the bf16 decode cache, whose position
    starts at the padded prompt length."""
    params, cfg, _, _ = lm("llama3_2_1b")
    server = Server(params, cfg, max_batch=4, max_len=32, device="cpu")
    calls = []
    real_prefill, real_decode = server._prefill, server._decode

    def prefill(p, batch):
        logits, cache = real_prefill(p, batch)
        calls.append(("prefill", cache["kv"][0].dtype, cache["pos"]))
        return logits, cache

    def decode(p, cache, batch):
        calls.append(("decode", cache["kv"][0].dtype, cache["pos"]))
        return real_decode(p, cache, batch)
    monkeypatch.setattr(server, "_prefill", prefill)
    monkeypatch.setattr(server, "_decode", decode)
    server.submit(Request(prompt=[1, 2, 3], max_new_tokens=2))
    server.submit(Request(prompt=[4, 5, 6, 7, 8], max_new_tokens=5))
    outs = server.step()
    assert [len(o) for o in outs] == [2, 5]
    assert calls == [("prefill", torch.float32, 5)] + [
        ("decode", torch.bfloat16, 5 + i) for i in range(5)]


# ---------------------------------------------------------------------------
# The admission path (the JAX package's LM cases)
# ---------------------------------------------------------------------------

def test_lm_overlong_prompt_rejected_typed(lm):
    params, cfg, _, _ = lm("llama3_2_1b")
    server = Server(params, cfg, max_batch=4, max_len=16, device="cpu")
    with pytest.raises(InvalidRequestError):
        server.submit(Request(prompt=list(range(20)), max_new_tokens=4))
    with pytest.raises(InvalidRequestError):     # prompt + gen > window
        server.submit(Request(prompt=[1, 2, 3], max_new_tokens=14))
    with pytest.raises(InvalidRequestError):
        server.submit(Request(prompt=[]))
    assert server.stats()["rejected"] == 3
    server.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
    outs = server.step()
    assert len(outs) == 1 and len(outs[0]) == 4


def test_lm_queue_bounded_sheds_typed(lm):
    params, cfg, _, _ = lm("llama3_2_1b")
    server = Server(params, cfg, max_batch=2, max_len=32, max_queue=2,
                    device="cpu")
    server.submit(Request(prompt=[1, 2], max_new_tokens=2))
    server.submit(Request(prompt=[3, 4], max_new_tokens=2))
    with pytest.raises(QueueFullError):
        server.submit(Request(prompt=[5, 6], max_new_tokens=2))
    s = server.stats()
    assert s["shed"] == 1 and s["queue_depth"] == 2
    assert len(server.step()) == 2


def test_lm_deadline_expires_typed_not_dropped(lm):
    params, cfg, _, _ = lm("llama3_2_1b")
    clk = FakeClock()
    server = Server(params, cfg, max_batch=4, max_len=32, clock=clk,
                    device="cpu")
    server.submit(Request(prompt=[1, 2], max_new_tokens=2))
    late = Request(prompt=[3, 4], max_new_tokens=2, deadline_s=0.5)
    server.submit(late)
    clk.advance(1.0)
    outs = server.step()
    assert len(outs) == 1
    assert [r for r, _ in server.expired_log] == [late]
    assert server.expired_log[0][1].code == "deadline_exceeded"
    assert server.stats()["expired"] == 1


def test_stats_and_instruments_are_the_reference_s(lm):
    params, cfg, jparams, jcfg = lm("llama3_2_1b")
    server = Server(params, cfg, max_batch=2, max_len=32, device="cpu")
    jsrv = jserve.Server(jparams, jcfg, max_batch=2, max_len=32)
    for srv, req in ((server, Request), (jsrv, jserve.Request)):
        srv.submit(req(prompt=[1, 2], max_new_tokens=2))
        srv.step()
    assert server.stats().keys() == jsrv.stats().keys()
    names = sorted(i.name for i in server.telemetry.registry.instruments())
    jnames = sorted(i.name for i in jsrv.telemetry.registry.instruments())
    assert names == jnames == sorted([
        "lm_rejected_total", "lm_queue_wait_seconds", "lm_step_seconds",
        "lm_queue_depth"])
    assert server.telemetry.histogram("lm_step_seconds").count == 1


def test_server_refuses_other_devices_and_families(lm):
    params, cfg, _, _ = lm("llama3_2_1b")
    with pytest.raises(ValueError, match="parameters are on cpu"):
        Server(params, cfg, device="meta")
    with pytest.raises(ValueError, match="rnn"):
        Server(params, dataclasses.replace(cfg, family="rnn"), device="cpu")


# ---------------------------------------------------------------------------
# The launcher and the example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "dbrx-132b", "xlstm-350m",
                                  "zamba2-2.7b", "whisper-tiny"])
def test_launcher_serves_on_the_cpu(capsys, arch):
    """One config of each family."""
    outs = launch_serve.main(["--arch", arch, "--device", "cpu",
                              "--requests", "3", "--new-tokens", "4"])
    assert [len(o) for o in outs] == [4, 4, 4]
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
    ap = launch_serve.build_parser()
    assert ap.parse_args(["--arch", "x"]).reduced
    assert not ap.parse_args(["--arch", "x", "--no-reduced"]).reduced


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "arctic-480b",
                                  "xlstm-350m", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_example_serves_on_the_cpu(capsys, arch):
    """One config of each family."""
    from repro_torch.examples import serve_lm
    outs = serve_lm.main(["--device", "cpu", "--arch", arch])
    assert [len(o) for o in outs] == [12] * 6
    assert "served 6 reqs / 72 tokens" in capsys.readouterr().out
    cfg = get_config(arch).reduced()
    assert all(0 <= t < cfg.vocab for o in outs for t in o)
