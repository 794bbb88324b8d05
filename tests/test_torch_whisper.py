"""whisper_small (an encoder-decoder: 12 non-causal encoder layers over
precomputed frame embeddings, 12 decoder layers with gated
cross-attention, sinusoidal positions and no RoPE) in the port against
the JAX reference, on the reduced config (2 + 2 layers, 64 frames, d 64;
f32), the CPU, with the reference's weights and the same numpy inputs.
The shared checks and their tolerances are in tests/xattn_parity.py;
every check but the one at init values sets the gates ``xgate`` to 0.5.

- The config field by field, full and reduced; the init tree; the
  groups (encoder: one non-causal attention sub-block; decoder:
  attention and cross-attention).
- ``sinusoidal_embedding`` and ``layer_norm`` within 1e-6.
- The encoder's output and ``mse`` on the block path (64 frames) and the
  token fallback (60 frames, not a block multiple), in kernel mode too.
- Prefill logits and every cache leaf (``ck``/``cv`` included), then four
  decode steps, in every DSA mode, block-aligned (K2's path) and not
  (the token path), the block selections as sets; at init values too.
- Greedy tokens of the static engine (with ``enc_x``) and of the
  continuous engine (blocking, no encoder input at admission) EQUAL to
  the reference's in every mode, and to solo ``generate``.
- No prompt buckets, paging, quantization, chunking or speculation.
- The training forward, a train step (1 and 2 microbatches) and the
  four-step curve with ``enc_x``; a checkpoint byte for byte; the CLIs.
- The reference's faults, which the port keeps: a decode step's token
  gets position 0's sinusoidal embedding; without DSA the 1500-frame
  encoder cannot run.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.models import common as JCM
from repro.models import transformer as JT
from repro.models.attention import RunFlags as JFlags
from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.inference import engine as TE
from repro_torch.launch import serve
from repro_torch.launch import train as LT
from repro_torch.models import blocks as TBL
from repro_torch.models import common as TCM
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunFlags
from repro_torch.tree import named_leaves

import xattn_parity as X

torch.set_num_threads(1)

ARCH = "whisper_small"


def test_config_and_tree_are_the_reference_ones():
    """Every field equals the reference's, full and reduced, and so does
    the analytic count; the port's own init has the reference's tree
    (the encoder groups and ``enc_norm``, each decoder layer's ``xattn``
    without a DSA predictor, ``xnorm`` and the scalar ``xgate``)."""
    for tc, jc in ((TB.get_config(ARCH), JB.get_config(ARCH)),
                   (TB.reduced(TB.get_config(ARCH)),
                    JB.reduced(JB.get_config(ARCH)))):
        X.fields_equal(tc, jc, tc.name)
        assert tc.num_params() == jc.num_params()
    jc, jparams, tc, tparams = X.params(ARCH)
    assert (tc.n_layers, tc.n_enc_layers, tc.enc_seq_len) == (2, 2, 64)
    assert TBL.group_defs(tc) == [TBL.SubBlockDef("attn", cross=True)]
    assert TBL.group_defs(tc, decoder=False) == [
        TBL.SubBlockDef("attn", causal=False)]
    assert TBL.n_groups(tc) == 2 and TBL.n_groups(tc, decoder=False) == 2
    own = TT.init_model(0, tc, device="cpu")
    shapes = {p: (tuple(t.shape), t.dtype) for p, t in named_leaves(own)}
    assert shapes == {p: (tuple(t.shape), t.dtype)
                      for p, t in named_leaves(tparams)}
    assert "/enc_groups/1/b0/attn/dsa/p" in shapes and "/enc_norm" in shapes
    assert "/groups/0/b0/xattn/wq" in shapes
    assert "/groups/0/b0/xattn/dsa/p" not in shapes
    assert shapes["/groups/1/b0/xgate"][0] == ()
    assert set(convert.to_reference(tparams)) == set(jparams)


def test_sinusoidal_and_layer_norm_match_reference():
    """Within 1e-6 at the reduced lengths (64 and 60 frames, 32 tokens;
    d 64).  At whisper's full 1500 x 768 the frequencies 10000^(-i/d) go
    through two f32 ``exp``s (XLA's and PyTorch's) that differ by an ulp
    on some i, and position p turns an ulp of the frequency (<= 2^-23, as
    f <= 1) into p ulps of the angle: there the bound is 1500 x 2^-23
    (1.8e-4)."""
    for length, d, atol in ((64, 64, 1e-6), (60, 64, 1e-6), (32, 64, 1e-6),
                            (1500, 768, 1500 * 2 ** -23)):
        got = TCM.sinusoidal_embedding(length, d)
        want = JCM.sinusoidal_embedding(length, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                                   rtol=0)
    got = TCM.sinusoidal_embedding(7, 64, torch.bfloat16)
    want = JCM.sinusoidal_embedding(7, 64, jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    rng = np.random.default_rng(0)
    x, g, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 5, 64), (64,), (64,)))
    got = TCM.layer_norm(*map(torch.from_numpy, (x, g, b)))
    want = JCM.layer_norm(*map(jnp.asarray, (x, g, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("frames,mode", [(64, "block"), (64, "kernel"),
                                         (60, "block"), (60, "faithful")])
def test_encoder_matches_reference(frames, mode):
    """The encoder's output (1e-4 of the largest magnitude) and its
    ``mse`` (rtol 1e-5): 64 frames take the block path (K2's plain
    version on "kernel", non-causal), 60 the token fallback."""
    jc, jparams, tc, tparams = X.params(ARCH, enc_seq_len=frames)
    enc_x = X.extras(tc, 2)["enc_x"]
    want, jaux = JT._encode(jparams, jc, JFlags(mode="train",
                                                dsa_mode=mode),
                            jnp.asarray(enc_x))
    got, taux = TT._encode(tparams, tc, RunFlags(mode="train",
                                                 dsa_mode=mode),
                           torch.from_numpy(enc_x))
    X.close(got.detach().numpy(), want, what="encoder output")
    np.testing.assert_allclose(float(taux["mse"]), float(jaux["mse"]),
                               rtol=X.METRIC_RTOL)
    assert float(taux["mse"]) > 0


@pytest.mark.parametrize("mode,plen", [(m, 32) for m in X.MODES]
                         + [("kernel", 40), ("block", 40)])
def test_prefill_and_decode_match_reference(mode, plen):
    """32 tokens take K2's block path in prefill, 40 the token path."""
    X.check_prefill_and_decode(ARCH, mode, plen)


def test_prefill_and_decode_at_init_gates_and_encoder_fallback():
    """At the reference's initial gates (0: the encoder does not reach the
    logits) and, with the gates set, through a 60-frame encoder (the
    token fallback) on the kernel path."""
    X.check_prefill_and_decode(ARCH, "kernel", 32, gate=0.0)
    cache = X.check_prefill_and_decode(ARCH, "kernel", 32,
                                       enc_seq_len=60)
    assert cache["groups"][0]["b0"]["xattn"]["ck"].shape[1] == 60


@pytest.mark.parametrize("mode,seq", [("off", 64), ("block", 64),
                                      ("faithful", 32)])
def test_train_forward_matches_reference(mode, seq):
    """Logits and the ``mse`` of the encoder and decoder layers.  The
    faithful case runs 32 tokens: its token top-k is discontinuous and
    4-bit predicted scores tie or nearly tie often, so at 64 one decoder
    row of the seed-0 batch (row 49) keeps another key on each side, as
    h2o's faithful case in tests/test_torch_train.py does at 128."""
    X.check_train_forward(ARCH, mode, seq)


@pytest.mark.parametrize("mode,loop", [(m, "scan") for m in X.MODES]
                         + [("kernel", "python")])
def test_greedy_tokens_equal_reference(mode, loop):
    eng = X.check_greedy_tokens(ARCH, mode, loop)
    assert not eng.bucket_prompts


@pytest.mark.parametrize("mode", X.MODES)
def test_continuous_equals_reference_and_solo(mode):
    X.check_continuous(ARCH, mode)


def test_envelopes_refuse_what_the_reference_refuses():
    X.check_envelopes(ARCH)
    _, _, tc, _ = X.params(ARCH)
    assert not TE.can_bucket_prompts(tc)


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("mode", ["block", "off"])
def test_train_step_matches_reference(mode, mb):
    """Every gradient, the encoder's and the gates' included."""
    X.check_train_step(ARCH, mode, mb)


def test_four_step_curve_matches_reference():
    X.check_four_step_curve(ARCH)


def test_state_checkpoints_in_reference_format(tmp_path):
    names = X.check_checkpoint(ARCH, tmp_path)
    assert "params.enc_groups.b0.attn.wq.npy" in names
    assert "opt.m.groups.b0.xgate.npy" in names


def test_reference_fault_whisper_decode_position_zero():
    """The reference's decoder adds ``sinusoidal_embedding(x.shape[1])``
    to the token embeddings (src/repro/models/transformer.py:296-297): in
    a decode step that is 1, so every decoded token gets position 0's
    embedding, while a prefill gives row i position i.  Prefilling 32
    tokens and decoding the 33rd therefore differs from prefilling all
    33, in both packages (DSA off, f32), and the port gives the
    reference's logits in each case."""
    jc, jparams, tc, tparams = X.params(ARCH)
    prompts = X.toks(3, 2, 33)
    ex = X.extras(tc, 2)
    jdf = JFlags(mode="decode", dsa_mode="off", long_context=True)
    tdf = RunFlags(mode="decode", dsa_mode="off", long_context=True)
    out = {}
    for pkg in ("ref", "port"):
        longer, stepped = [], []
        for n in (33, 32):
            if pkg == "ref":
                c = JT.init_cache(jc, 2, 48, jdf, dtype=jnp.float32)
                lg, _, c = JT.forward(
                    jparams, jc, dataclasses.replace(jdf, mode="prefill"),
                    {"tokens": jnp.asarray(prompts[:, :n]),
                     "enc_x": jnp.asarray(ex["enc_x"])}, caches=c)
                if n == 32:
                    c = JT.unstack_group_caches(c)
                    lg, _ = JT.decode_step(jparams, jc, jdf,
                                           jnp.asarray(prompts[:, 32:]), c)
                lg = np.asarray(lg)
            else:
                c = TT.init_cache(tc, 2, 48, tdf, dtype=torch.float32,
                                  device="cpu")
                with torch.inference_mode():
                    lg, _ = TT.forward(
                        tparams, tc, dataclasses.replace(tdf, mode="prefill"),
                        torch.from_numpy(prompts[:, :n]), c,
                        extras={"enc_x": torch.from_numpy(ex["enc_x"])})
                    if n == 32:
                        lg, _ = TT.decode_step(
                            tparams, tc, tdf,
                            torch.from_numpy(prompts[:, 32:]), c)
                lg = lg.numpy()
            (longer if n == 33 else stepped).append(lg[:, -1])
        out[pkg] = (longer[0], stepped[0])
        gap = np.abs(longer[0] - stepped[0]).max()
        assert gap > 100 * X.REL * np.abs(longer[0]).max(), (pkg, gap)
    for got, want in zip(out["port"], out["ref"]):
        X.close(got, want, what="last-row logits")


def test_reference_fault_whisper_encoder_needs_dsa_at_1500_frames():
    """With DSA off (or disabled) the reference's attention is dense up to
    1024 queries and q-chunked by 256 above (src/repro/models/
    attention.py:299-302), and its ``flash_attention`` asserts a whole
    number of chunks: 1500 frames are not one, so whisper's encoder
    cannot run at its published length without DSA, whose token
    fallback takes it on every DSA path.  The port keeps the reference's
    dispatch and raises too."""
    jc, jparams, tc, tparams = X.params(ARCH, enc_seq_len=1500)
    enc_x = X.extras(tc, 1)["enc_x"]
    with pytest.raises(AssertionError):
        JT._encode(jparams, jc, JFlags(mode="train", dsa_mode="off"),
                   jnp.asarray(enc_x))
    with pytest.raises(ValueError, match="Lq=1500 is not a multiple"):
        TT._encode(tparams, tc, RunFlags(mode="prefill", dsa_mode="off"),
                   torch.from_numpy(enc_x))


def test_serve_and_train_cli(capsys):
    """``serve --arch whisper_small --reduced`` static (kernel, bf16
    cache, ``enc_x`` from the seed) and continuous (block); ``train``
    feeds tokens only, as the reference's does."""
    res = serve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                      "--prompt-len", "32", "--new-tokens", "6", "--dsa",
                      "--dsa-mode", "kernel", "--cache-dtype", "bfloat16",
                      "--device", "cpu"])
    assert res.tokens.shape == (2, 6)
    res, eng = serve.main(["--arch", ARCH, "--reduced", "--continuous",
                           "--requests", "3", "--slots", "2", "--dsa",
                           "--dsa-mode", "block", "--prompt-len", "40",
                           "--new-tokens", "4", "--device", "cpu"])
    assert all(r.status == "ok" for r in res) and len(res) == 3
    assert not eng.chunked
    assert "continuous: 3 requests" in capsys.readouterr().out
    out = LT.main(["--arch", ARCH, "--reduced", "--steps", "2", "--seq",
                   "32", "--batch", "2", "--log-interval", "1",
                   "--device", "cpu"])
    assert all(m["mse"] > 0 for m in out.metrics)
    assert "[done] 2 steps" in capsys.readouterr().out
