"""The port's ``quickstart`` example on the CPU, in-process, with the
reference example's recall assertion (recall@5 = 1.0 against the
plaintext top-5).  One intra-op thread: beside other busy test workers
torch's thread pools make the plain NTT's many small ops slow."""

import torch

from repro_torch.examples import quickstart


def test_quickstart_recall(capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert quickstart.main(["--device", "cpu"]) == 1.0
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out
    assert "recall vs plaintext top-5: 100%" in out
    assert "module-2 path=direct" in out
