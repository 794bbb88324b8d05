"""llama_3_2_vision (a llama text backbone whose groups of 5 layers carry a
gated cross-attention sub-layer at index 3, over precomputed image patch
embeddings) in the port against the JAX reference, on the reduced config
(one group of 5, 32 image tokens, d 64; f32), the CPU, with the
reference's weights and the same numpy inputs.  The shared checks and
their tolerances are in tests/xattn_parity.py; every check but the one
at init values sets the gates ``xgate`` to 0.5.

- The config field by field, full and reduced; the init tree; depth cuts
  keep whole groups of 5.
- Prefill logits and every cache leaf (``ck``/``cv`` included), then four
  decode steps, in every DSA mode, block-aligned (K2's path) and not
  (the token path), block selections as sets; at init values; and with
  no image: prefill skips the cross sub-layer, its ``ck``/``cv`` stay
  zero and decode attends them, as in the reference.
- Greedy tokens of the static engine (with and without ``img``) and of the
  continuous engine (blocking, no image at admission) EQUAL to the
  reference's in every mode, and to solo ``generate``.
- No paging, quantization, chunking or speculation.
- The training forward, a train step (1 and 2 microbatches) and the
  four-step curve with ``img``; a checkpoint byte for byte; the CLIs.
- The reference's fault: its analytic ``num_params`` leaves out the
  cross-attention sub-layers and an encoder, which the port keeps.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.launch import serve
from repro_torch.launch import train as LT
from repro_torch.models import blocks as TBL
from repro_torch.models import transformer as TT
from repro_torch.tree import named_leaves

import xattn_parity as X

torch.set_num_threads(1)

ARCH = "llama_3_2_vision"


def test_config_and_tree_are_the_reference_ones():
    """Every field equals the reference's, full and reduced, and so does
    the analytic count; the port's own init has the reference's tree
    (``xattn`` without a DSA predictor, ``xnorm`` and the scalar
    ``xgate`` on the fourth sub-block of each group)."""
    for tc, jc in ((TB.get_config(ARCH), JB.get_config(ARCH)),
                   (TB.reduced(TB.get_config(ARCH)),
                    JB.reduced(JB.get_config(ARCH)))):
        X.fields_equal(tc, jc, tc.name)
        assert tc.num_params() == jc.num_params()
    jc, jparams, tc, tparams = X.params(ARCH)
    assert (tc.n_layers, tc.n_image_tokens) == (5, 32)
    assert [d.cross for d in TBL.group_defs(tc)] == [False] * 3 + [True,
                                                                   False]
    assert TBL.n_groups(tc) == 1
    assert TBL.n_groups(TB.get_config(ARCH)) == 8
    own = TT.init_model(0, tc, device="cpu")
    shapes = {p: (tuple(t.shape), t.dtype) for p, t in named_leaves(own)}
    assert shapes == {p: (tuple(t.shape), t.dtype)
                      for p, t in named_leaves(tparams)}
    assert "/groups/0/b3/xattn/wk" in shapes
    assert "/groups/0/b3/xattn/dsa/p" not in shapes
    assert "/groups/0/b2/xattn/wk" not in shapes
    assert shapes["/groups/0/b3/xgate"][0] == ()
    assert set(convert.to_reference(tparams)) == set(jparams)


def test_depth_cuts_keep_whole_groups():
    full = TB.get_config(ARCH)
    for n in (5, 10, 40):
        cfg = TB.cut_layers(full, n)
        assert TBL.n_groups(cfg) == n // 5 and len(TBL.group_defs(cfg)) == 5
        assert cfg.num_params() == dataclasses.replace(
            JB.get_config(ARCH), n_layers=n).num_params()
    for n in (3, 12):
        with pytest.raises(ValueError, match="whole groups of 5"):
            TB.cut_layers(full, n)


@pytest.mark.parametrize("mode,plen", [(m, 32) for m in ("off", "block",
                                                        "kernel")]
                         + [("faithful", 48), ("kernel", 40), ("block", 40)])
def test_prefill_and_decode_match_reference(mode, plen):
    """32 tokens take K2's block path in prefill, 40 the token path.  The
    faithful case runs 48 tokens: its token top-k is discontinuous and
    4-bit predicted levels tie or nearly tie, so at 32 the cross
    sub-layer's last-bit differences (1e-6 of the residual stream) move
    one row of the seed-1 prompts (batch row 1, token 12) to another key
    in the next layer, as h2o's faithful case in
    tests/test_torch_train.py does at 128 tokens; at gate 0 the two agree
    there."""
    X.check_prefill_and_decode(ARCH, mode, plen)


def test_prefill_and_decode_without_image_and_at_init_gates():
    """No ``img``: prefill skips the cross sub-layer (its ``ck``/``cv``
    stay zero) and decode attends the zero cache, as the reference's do;
    and with an image at the initial gates (0)."""
    cache = X.check_prefill_and_decode(ARCH, "kernel", 32,
                                       with_extras=False)
    xc = list(TT.cross_caches(cache))
    assert len(xc) == 1 and all(not t.any() for c in xc for t in c.values())
    X.check_prefill_and_decode(ARCH, "block", 32, gate=0.0)


@pytest.mark.parametrize("mode", ["off", "block", "faithful"])
def test_train_forward_matches_reference(mode):
    X.check_train_forward(ARCH, mode)


@pytest.mark.parametrize("mode,loop,image", [(m, "scan", True)
                                             for m in X.MODES]
                         + [("kernel", "python", True),
                            ("kernel", "scan", False)])
def test_greedy_tokens_equal_reference(mode, loop, image):
    eng = X.check_greedy_tokens(ARCH, mode, loop, with_extras=image)
    assert eng.bucket_prompts


def test_generate_zeroes_the_image_of_an_earlier_call():
    """A generate without ``img`` after one with it on the same engine
    gives a fresh engine's tokens: the prefill zeroes ``ck``/``cv``."""
    eng = X.check_greedy_tokens(ARCH, "block", "scan", with_extras=True)
    again = eng.generate(X.toks(4, 2, 40), 8)
    np.testing.assert_array_equal(
        again.tokens, X.reference_tokens(ARCH, "block", False))


@pytest.mark.parametrize("mode", X.MODES)
def test_continuous_equals_reference_and_solo(mode):
    X.check_continuous(ARCH, mode)


def test_envelopes_refuse_what_the_reference_refuses():
    X.check_envelopes(ARCH)


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("mode", ["block", "off"])
def test_train_step_matches_reference(mode, mb):
    """Every gradient, the cross sub-layer's and its gate's included."""
    X.check_train_step(ARCH, mode, mb)


def test_four_step_curve_matches_reference():
    X.check_four_step_curve(ARCH)


def test_state_checkpoints_in_reference_format(tmp_path):
    names = X.check_checkpoint(ARCH, tmp_path)
    assert "params.groups.b3.xattn.wq.npy" in names
    assert "opt.v.groups.b3.xgate.npy" in names


def _counted(path: str) -> bool:
    """The leaves the analytic count covers: the embedding and head, each
    self-attention's projections and each MLP."""
    parts = path.split("/")
    return (path in ("/embed", "/lm_head")
            or (parts[1] == "groups" and parts[-2] in ("attn", "mlp")
                and parts[-1] != "p" and "dsa" not in parts))


@pytest.mark.parametrize("arch", ["llama_3_2_vision", "whisper_small"])
def test_reference_fault_num_params_omits_encoder_and_cross(arch):
    """The reference's analytic ``num_params`` (src/repro/configs/base.py:
    124-160, the 6 N D count) sums the embeddings and each decoder
    layer's attention projections and MLP: it equals those leaves of the
    init tree, in both packages, and leaves out every cross-attention
    sub-layer (``xattn``, ``xnorm``, ``xgate``) and whisper's whole
    encoder, which the tree holds.  The port keeps the reference's
    count."""
    jc, jparams, tc, tparams = X.params(arch)
    for tree in (tparams, jax.tree.map(np.asarray, jparams)):
        leaves = dict(named_leaves(tree))
        sizes = {p: int(np.prod(np.shape(a))) for p, a in leaves.items()}
        if tree is not tparams:       # the reference's stacked layout
            sizes = {p.replace("/groups/", "/groups/0/", 1)
                     if p.startswith("/groups/") else p: n
                     for p, n in sizes.items()}
        counted = sum(n for p, n in sizes.items() if _counted(p))
        left_out = sum(n for p, n in sizes.items()
                       if "/x" in p or p.startswith(("/enc_groups",
                                                     "/enc_norm")))
        assert counted == tc.num_params() == jc.num_params()
        assert left_out > 0
        assert sum(sizes.values()) > tc.num_params() + left_out - 1
    if arch == "whisper_small":
        assert any(p.startswith("/enc_groups") for p in sizes)


def test_serve_and_train_cli(capsys):
    """``serve --arch llama_3_2_vision --reduced`` static (kernel, bf16
    cache, ``img`` from the seed) and continuous (block); ``--layers``
    cuts whole groups; ``train`` feeds tokens only, as the reference's
    does (no cross-attention runs: mse from the self-attention alone)."""
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
    with pytest.raises(ValueError, match="whole groups"):
        serve.main(["--arch", ARCH, "--layers", "12", "--device", "cpu"])
    out = LT.main(["--arch", ARCH, "--reduced", "--steps", "2", "--seq",
                   "32", "--batch", "2", "--log-interval", "1",
                   "--device", "cpu"])
    assert all(m["mse"] > 0 for m in out.metrics)
    assert "[done] 2 steps" in capsys.readouterr().out
