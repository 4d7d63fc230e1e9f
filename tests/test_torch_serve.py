"""The port's serving loop against the JAX reference's, on the CPU.

Both loops run the same float32 smoke ``qwen3_0_6b`` (the reference's
weights carried across by ``from_reference``) over the same requests:
ragged prompt lengths, ragged token budgets, 3 slots and 7 requests, so
slots refill while others decode.  Greedy decoding must give identical
tokens for every request.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.model import LanguageModel as JModel
from repro.models.params import init_params as j_init_params
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServeLoop as JServeLoop
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LanguageModel
from repro_torch.models.params import from_reference
from repro_torch.runtime.serve import Request, ServeLoop

PROMPT_LENS = [8, 11, 8, 13, 11, 8, 13]   # few lengths: JAX compiles each
MAX_NEW = [3, 5, 4, 6, 3, 5, 4]


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(2, vocab, n).astype(np.int32),
                max_new_tokens=m)
            for i, (n, m) in enumerate(zip(PROMPT_LENS, MAX_NEW))]


def test_serve_loop_tokens_equal_reference():
    jcfg = dataclasses.replace(
        j_get_config("qwen3_0_6b").smoke(dtype="float32"), remat=False)
    jm = JModel(jcfg)
    jparams = j_init_params(jm.param_specs(), jax.random.PRNGKey(0))
    want = JServeLoop(jm, jparams, num_slots=3, max_len=48, eos_id=0).run(
        _requests(JRequest, jcfg.vocab_size))

    tm = LanguageModel(get_config("qwen3_0_6b").smoke(dtype="float32"),
                       device="cpu")
    from_reference(tm, jax.tree_util.tree_map(np.asarray, jparams))
    loop = ServeLoop(tm, num_slots=3, max_len=48, eos_id=0, device="cpu")
    got = loop.run(_requests(Request, jcfg.vocab_size))

    assert [r.uid for r in got] == [r.uid for r in want]
    for a, b in zip(got, want):
        assert a.generated == b.generated, a.uid
        assert 1 <= len(a.generated) <= a.max_new_tokens
    assert len(loop.prefill_seconds) == len(PROMPT_LENS)
    assert len(loop.decode_seconds) >= max(MAX_NEW)
    assert loop.nonfinite_logits == 0


def test_serve_loop_mamba_runs_with_ragged_slots():
    tm = LanguageModel(get_config("mamba2_780m").smoke(dtype="float32"),
                       device="cpu")
    loop = ServeLoop(tm, num_slots=2, max_len=48, eos_id=-1, device="cpu")
    done = loop.run(_requests(Request, tm.cfg.vocab_size)[:4])
    assert sorted(r.uid for r in done) == [0, 1, 2, 3]
    for r in done:
        assert len(r.generated) == r.max_new_tokens
        assert all(0 <= t < tm.cfg.vocab_size for t in r.generated)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mamba2_780m"])
def test_launch_serve_smoke_on_cpu(arch, capsys):
    assert launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--slots", "2",
                              "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "3 requests" in out and "on cpu" in out


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("qwen3_0_6b").smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LanguageModel(cfg)
    m = LanguageModel(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.to_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(m, num_slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen3_0_6b", "--smoke"])


def test_serve_loop_rejects_a_model_on_another_device():
    m = LanguageModel(get_config("qwen3_0_6b").smoke(), device="cpu")
    m.to("meta")
    with pytest.raises(ValueError, match="lies on"):
        ServeLoop(m, num_slots=2, max_len=16, device="cpu")
