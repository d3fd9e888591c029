"""The port's hardware self-test: on the CPU path it passes every check;
without a card and without --device cpu it refuses to run (exit 3)."""
import torch

from rupphash_tpu_torch.tools import prof_nz, selftest


def test_selftest_cpu_path_passes(capsys):
    assert selftest.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "validating the CPU path" in out
    assert "[SKIP] bench.jpg fixture unavailable" in out
    for name in ("randomized K1 batch vs golden", "mixed-shape batch vs golden",
                 "hybrid kernel K2 dihedral vs K1", "pHash vs golden",
                 "K3 grouping planted pair", "serve exact query",
                 "find_edges_fast planted cluster"):
        assert f"[OK] {name}" in out
    assert "[FAIL]" not in out
    assert "kernels: pdq_hash_kernel=0 pdq_coeffs_kernel=0" in out
    assert out.rstrip().endswith("PASS (0 failing checks)")


def test_tools_exit_3_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert selftest.main([]) == 3
    assert prof_nz.main([]) == 3
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err
    assert "PASS" not in capsys.readouterr().out
