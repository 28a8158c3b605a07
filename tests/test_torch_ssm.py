"""repro_torch.models.ssm (Mamba, mLSTM, sLSTM) against repro.models.ssm.

Both packages get the same params (drawn by the reference, crossing
through numpy) and the same seeded inputs, on the hymba (Mamba) and xlstm
(mLSTM, sLSTM) smoke configs in fp32, at S = 300: two chunks of
``SSM_CHUNK`` / ``MLSTM_CHUNK`` = 256, the second padded. Tolerances: 2e-5
for the forwards, the decode outputs and the states (both sides compute in
fp32 but sum in different orders, XLA:CPU vs ATen; the scans combine in
other trees); 1e-4 for the mLSTM's decode against its chunked forward (two
formulations of one recurrence). The reference runs under ``jax.jit``.

Two reference faults are pinned here, and the port holds the invariant the
reference's docstring states (its chunked mLSTM is the decode step's
recurrence), not the faults (ROADMAP §3): the reference's
``mlstm_decode_step`` leaves out the output gate, so its ``LM.decode_step``
on the xlstm smoke config leaves its own forward; and its
``mlstm_chunk_body`` reads the carried memory transposed, so its chunked
forward leaves its own one-chunk forward after the first chunk. The port's
``mlstm_apply`` is held against the reference's run as one chunk.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.models import ssm as r_ssm  # noqa: E402
from repro.models.lm import LM  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from _torch_parity import port_config  # noqa: E402

S, B = 300, 2
TOL = dict(rtol=2e-5, atol=2e-5)
STATE = {"mamba": ("conv", "h"), "mlstm": ("conv", "c", "n", "m"),
         "slstm": ("h", "c", "n", "m")}


@pytest.fixture(autouse=True)
def one_thread():
    """Step-by-step runs of many small CPU ops run on one thread: beside
    the other test workers, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return dataclasses.replace(r_registry.get_smoke_config(arch),
                               compute_dtype="float32")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


_MIXERS: dict = {}


def mixer(name: str):
    """(reference cfg, port cfg, reference params, port params, x [B,S,d])
    of one mixer, once per process."""
    if name not in _MIXERS:
        cfg = _cfg("hymba-1.5b" if name == "mamba" else "xlstm-125m")
        init = getattr(r_ssm, f"{name}_params")
        p = jax.tree.map(np.asarray, jax.jit(lambda k: init(k, cfg))(
            jax.random.PRNGKey(len(name))))
        x = np.random.default_rng(len(name)).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        _MIXERS[name] = (cfg, port_config(cfg), p,
                         params_from_reference(p, device="cpu"), x)
    return _MIXERS[name]


def _ref_apply(name, cfg, p, x, chunk=None):
    """The reference's ``<name>_apply`` under jit; ``chunk`` overrides
    ``MLSTM_CHUNK`` while it traces."""
    fn = getattr(r_ssm, f"{name}_apply")
    with pytest.MonkeyPatch.context() as mp:
        if chunk:
            mp.setattr(r_ssm, "MLSTM_CHUNK", chunk)
        return _f32(jax.jit(lambda p, x: fn(cfg, p, x))(p, jnp.asarray(x)))


def _decode_both(name):
    """Both packages' decode steps over the mixer's S tokens from their
    initial states; each step's state must equal the reference's. Returns
    (port outputs, reference outputs), [B,S,d] each."""
    cfg, tcfg, p, tp, x = mixer(name)
    init = getattr(r_ssm, f"{name}_init_state")
    rs = init(cfg, B)
    ts = getattr(t_ssm, f"{name}_init_state")(tcfg, B, device="cpu")
    step = jax.jit(lambda p, x, s: getattr(r_ssm, f"{name}_decode_step")(
        cfg, p, x, s))
    tstep = getattr(t_ssm, f"{name}_decode_step")
    got, want = [], []
    for t in range(S):
        ro, rs = step(p, jnp.asarray(x[:, t:t + 1]), rs)
        to, ts2 = tstep(tcfg, tp, torch.from_numpy(x[:, t:t + 1]), ts)
        assert ts2 is ts                          # written in place
        for key in STATE[name]:
            np.testing.assert_allclose(_f32(ts[key]), _f32(rs[key]), **TOL,
                                       err_msg=f"{name} {key} at step {t}")
        got.append(_f32(to))
        want.append(_f32(ro))
    return np.concatenate(got, 1), np.concatenate(want, 1)


@pytest.mark.parametrize("name", ["mamba", "slstm"])
def test_apply_matches_reference(name):
    cfg, tcfg, p, tp, x = mixer(name)
    got = getattr(t_ssm, f"{name}_apply")(tcfg, tp, torch.from_numpy(x))
    assert got.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(_f32(got), _ref_apply(name, cfg, p, x), **TOL)


def test_mlstm_apply_matches_reference_one_chunk():
    """The port's two-chunk mLSTM equals the reference's run as one chunk
    at every position, and the reference's own two-chunk run on the first
    chunk."""
    cfg, tcfg, p, tp, x = mixer("mlstm")
    got = _f32(t_ssm.mlstm_apply(tcfg, tp, torch.from_numpy(x)))
    assert t_ssm.MLSTM_CHUNK == r_ssm.MLSTM_CHUNK == 256 < S
    np.testing.assert_allclose(got, _ref_apply("mlstm", cfg, p, x, 512),
                               **TOL)
    np.testing.assert_allclose(got[:, :256],
                               _ref_apply("mlstm", cfg, p, x)[:, :256], **TOL)


def test_reference_mlstm_chunks_leave_the_recurrence():
    """Pins the reference's chunk fault: its two-chunk forward equals its
    one-chunk forward on the first chunk and leaves it after (by more than
    1.0). If the reference is repaired, this case fails and says so."""
    cfg, _, p, _, x = mixer("mlstm")
    two, one = (_ref_apply("mlstm", cfg, p, x, c) for c in (None, 512))
    np.testing.assert_allclose(two[:, :256], one[:, :256], **TOL)
    gap = float(np.abs(two[:, 256:] - one[:, 256:]).max())
    assert gap > 1.0, (f"the reference's chunked mLSTM now follows its "
                       f"one-chunk form past the first chunk (gap {gap}): "
                       "update ROADMAP §3 and this test")


@pytest.mark.parametrize("name", ["mamba", "slstm"])
def test_decode_step_matches_reference(name):
    got, want = _decode_both(name)
    np.testing.assert_allclose(got, want, **TOL)


def test_mlstm_decode_step_state_and_outputs():
    """The port's mLSTM decode: its state equals the reference's after
    every step (the gate fault leaves the state alone), and its outputs,
    stacked over the steps, equal the reference's forward on the same
    tokens (run as one chunk, and as two on the first chunk)."""
    cfg, _, p, _, x = mixer("mlstm")
    got, _ = _decode_both("mlstm")
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, _ref_apply("mlstm", cfg, p, x, 512),
                               **tol)
    np.testing.assert_allclose(got[:, :256],
                               _ref_apply("mlstm", cfg, p, x)[:, :256], **tol)


def test_reference_lm_decode_leaves_its_forward():
    """Pins the reference's gate fault: on the xlstm smoke config its
    ``LM.decode_step`` logits differ from its own forward's by more than
    1.0 over 24 tokens; the port's decode holds the reference's forward
    within 1e-4. If the reference is repaired, this case fails and says
    so."""
    cfg = _cfg("xlstm-125m")
    rm, tm = LM(cfg), TLM(port_config(cfg))
    params = jax.tree.map(np.asarray, jax.jit(rm.init)(
        jax.random.PRNGKey(3)))
    tparams = params_from_reference(params, device="cpu")
    s = 24
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, s))
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (B, s))
    fwd = _f32(jax.jit(lambda p, t: rm.logits(p, rm.hidden(
        p, rm.embed(p, {"tokens": t}), pos)[0]))(params, jnp.asarray(toks)))
    step = jax.jit(rm.decode_step)
    rc, tc = rm.init_cache(B, s), tm.init_cache(B, s, device="cpu")
    ref, port = [], []
    for t in range(s):
        lg, rc = step(params, rc, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                      jnp.int32(t))
        ref.append(_f32(lg)[:, 0])
        lg, tc = tm.decode_step(tparams, tc, torch.from_numpy(
            toks[:, t:t + 1]), t)
        port.append(_f32(lg)[:, 0])
    gap = float(np.abs(np.stack(ref, 1) - fwd).max())
    assert gap > 1.0, (f"the reference's xLSTM decode now follows its "
                       f"forward (gap {gap}): update ROADMAP §3 and this "
                       "test")
    np.testing.assert_allclose(np.stack(port, 1), fwd, rtol=1e-4, atol=1e-4)
