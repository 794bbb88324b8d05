"""The port's Engine against the JAX reference's Engine on reduced yi_6b:
greedy tokens EQUAL for dsa_mode off, block and kernel, both decode loops,
and a ragged batch.  Plus the port's own rules: entry points never fall
back to the CPU on their own, and no module of the port imports JAX or
the reference.
"""
import ast
import dataclasses
import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.inference.engine import Engine as JEngine
from repro.models.transformer import init_model as jinit_model
from repro_torch import convert
from repro_torch.configs.base import get_config, reduced
from repro_torch.inference import engine as TE
from repro_torch.launch import serve

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_NEW = 8
KW = dict(max_len=96, long_context=True)


@functools.lru_cache(maxsize=None)
def _setup():
    jc = jreduced(jget_config("yi_6b"))
    jparams, _ = jinit_model(jax.random.PRNGKey(0), jc)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    prompts = np.random.default_rng(1).integers(
        1, jc.vocab - 4, size=(2, 48)).astype(np.int32)
    return jc, jparams, tparams, prompts


@functools.lru_cache(maxsize=None)
def _reference_tokens(mode: str, ragged: bool) -> np.ndarray:
    jc, jparams, _, prompts = _setup()
    lengths = np.array([48, 29], np.int32) if ragged else None
    res = JEngine(jc, jparams, dsa_mode=mode, loop="scan", **KW).generate(
        prompts, N_NEW, lengths=lengths)
    return np.asarray(res.tokens)


@pytest.mark.parametrize("loop", ["scan", "python"])
@pytest.mark.parametrize("mode", ["off", "block", "kernel"])
def test_greedy_tokens_equal_reference(mode, loop):
    _, _, tparams, prompts = _setup()
    eng = TE.Engine(reduced(get_config("yi_6b")), tparams, dsa_mode=mode,
                    loop=loop, device="cpu", **KW)
    res = eng.generate(prompts, N_NEW)
    np.testing.assert_array_equal(res.tokens, _reference_tokens(mode, False))
    want_steps = (TE.pow2_bucket(N_NEW - 1, TE.STEP_BUCKET_FLOOR)
                  if loop == "scan" else N_NEW - 1)
    assert res.decode_steps == want_steps
    assert res.tokens_per_s == pytest.approx(
        2 * res.decode_steps / res.decode_s, rel=1e-6)


@pytest.mark.parametrize("mode", ["off", "block", "kernel"])
def test_ragged_batch_tokens_equal_reference(mode):
    _, _, tparams, prompts = _setup()
    eng = TE.Engine(reduced(get_config("yi_6b")), tparams, dsa_mode=mode,
                    device="cpu", **KW)
    res = eng.generate(prompts, N_NEW, lengths=np.array([48, 29], np.int32))
    np.testing.assert_array_equal(res.tokens, _reference_tokens(mode, True))


def test_sampled_chain_is_seeded():
    _, _, tparams, prompts = _setup()
    eng = TE.Engine(reduced(get_config("yi_6b")), tparams, dsa_mode="block",
                    device="cpu", **KW)
    a = eng.generate(prompts, 6, greedy=False, seed=3).tokens
    b = eng.generate(prompts, 6, greedy=False, seed=3).tokens
    np.testing.assert_array_equal(a, b)


def test_engine_validates_requests():
    _, _, tparams, prompts = _setup()
    cfg = reduced(get_config("yi_6b"))
    eng = TE.Engine(cfg, tparams, device="cpu", **KW)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(prompts, 60)
    with pytest.raises(ValueError, match="empty"):
        eng.generate(prompts, 2, lengths=np.array([0, 3]))
    with pytest.raises(ValueError, match="dsa_mode"):
        TE.Engine(cfg, tparams, dsa_mode="dense", device="cpu")
    # faithful is ported: the engine takes it
    assert TE.Engine(cfg, tparams, dsa_mode="faithful",
                     device="cpu").decode_flags.dsa_mode == "faithful"


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no device given, the entry points want the card: without one
    they raise and never carry on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tparams, _ = _setup()
    cfg = reduced(get_config("yi_6b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TE.Engine(cfg, tparams)
    from repro_torch.models.transformer import init_model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_model(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "yi_6b", "--reduced"])


def test_card_device_carries_its_index(monkeypatch):
    """Tensors made on "cuda" lie on "cuda:<n>"; the entry points compare
    devices, so the card they resolve to names its index."""
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_runs_on_cpu_when_asked(capsys):
    res = serve.main(["--arch", "yi_6b", "--reduced", "--batch", "2",
                      "--prompt-len", "32", "--new-tokens", "4", "--dsa",
                      "--dsa-mode", "kernel", "--device", "cpu"])
    assert res.tokens.shape == (2, 4)
    assert "first new tokens" in capsys.readouterr().out


def test_reference_fault_bf16_with_f32_cache():
    """Found by the port: the reference's prefill cannot fill its default
    f32 K/V cache from bf16 activations (lax.dynamic_update_slice refuses
    the mixed dtypes), so a bf16 model does not serve there.  The port
    casts the rows to the cache's dtype and serves it."""
    jc, _, _, prompts = _setup()
    jc16 = dataclasses.replace(jc, dtype="bfloat16", param_dtype="bfloat16")
    jparams, _ = jinit_model(jax.random.PRNGKey(0), jc16)
    with pytest.raises(TypeError, match="same dtypes"):
        JEngine(jc16, jparams, dsa_mode="kernel", **KW).generate(prompts, 2)
    tc16 = dataclasses.replace(reduced(get_config("yi_6b")),
                               dtype="bfloat16", param_dtype="bfloat16")
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    assert tparams["embed"].dtype == torch.bfloat16
    res = TE.Engine(tc16, tparams, dsa_mode="kernel", device="cpu",
                    **KW).generate(prompts, 2)
    assert res.tokens.shape == (2, 2)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    (ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)
