"""The port's serving CLI on the CPU: the sampling, prefix-cache and
speculative flags run through to the engine with the JAX CLI's meanings;
the sharding flags refuse to run without a named backend (the tracing,
metrics, profiling and cost-report flags run: ``tests/test_torch_obs.py``)."""
import pytest

from repro_torch.launch import serve as serve_cli
from repro_torch.serve.sampling import SamplingParams

SMALL = ["--device", "cpu", "--requests", "3", "--prompt-len", "6",
         "--new-tokens", "4", "--weights", "fp16"]


def test_cli_runs_sampled_cached_speculative(capsys):
    eng = serve_cli.main(SMALL + [
        "--temperature", "0.8", "--top-k", "5", "--top-p", "0.9",
        "--seed", "3", "--logprobs", "--prefix-cache",
        "--sys-prompt-len", "32", "--speculative", "2"])
    assert eng._default_sp == SamplingParams(temperature=0.8, top_k=5,
                                             top_p=0.9, seed=3,
                                             logprobs=True)
    assert eng.prefix_cache is not None and eng._spec_k == 2
    s = eng.stats
    assert s.tokens_out == 12 and s.cache_hits == 2
    out = capsys.readouterr().out
    assert "prefix cache: 2 hits" in out and "speculative k=2" in out
    assert "req 0 logprobs" in out


@pytest.mark.parametrize("flag", [
    ["--data-shards", "2"], ["--model-shards", "2"]])
def test_cli_refuses_unported_flags(flag, capsys):
    """A shard flag without ``--dist-backend`` exits 2 naming the flag the
    mesh needs: the backend is never picked by falling back (the mesh
    itself runs in ``tests/test_torch_mesh_serve.py``)."""
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(SMALL + flag)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert flag[0] in err and "a mesh needs --dist-backend" in err
