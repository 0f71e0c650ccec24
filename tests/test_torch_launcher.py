"""The port's serving launcher on the CPU: ``--long-prompts`` makes
every 4th request four times ``--prompt-len`` long, as the JAX launcher
does: five requests of 8 tokens carry 88 prompt tokens instead of 40
(read off the chunked prefill's count).
"""
import pytest

pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402

ARGS = ["--arch", "minitron-4b", "--device", "cpu", "--batch", "2",
        "--requests", "5", "--prompt-len", "8", "--max-new-tokens", "6"]


@pytest.mark.parametrize("long_prompts,tokens", [(False, 40), (True, 88)])
def test_long_prompts(capsys, long_prompts, tokens):
    serve.main(ARGS + ["--engine", "paged", "--prefill-chunk", "8"]
               + (["--long-prompts"] if long_prompts else []))
    out = capsys.readouterr().out
    assert f"prefill_tokens={tokens}" in out
    assert "tokens=25 " in out          # 5 requests x (6 - the first)

