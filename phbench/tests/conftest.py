"""The benchmark's own tests: `python -m pytest phbench/tests` from the
root of a checkout.  Those marked `cuda` need a card and skip without
one; the rest run the cells at a tiny size with the port pinned to the
CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a cell of a driver that the benchmark lacks, as a later PR would add
# it: files laid out as in the benchmark's folder, and entries.json, the
# entries for BENCHMARK.json ("reports": the end-to-end metrics whose
# `workloads` lists gain the stand-in's cells)
STANDIN = Path(__file__).resolve().parent / "standin_cell"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (runs a cell of the benchmark)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda", 0)


def build_standin(dst: Path) -> tuple[dict, Path]:
    """A checkout at `dst` that is this one's BENCHMARK.json and
    benchmark folder with the stand-in cell added as new files and new
    entries alone; (its manifest, dst)."""
    from phbench import harness

    bench = dst / harness.BENCH
    shutil.copytree(harness.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src in sorted(STANDIN.rglob("*")):
        rel = src.relative_to(STANDIN)
        if src.is_dir() or rel == Path("entries.json"):
            continue
        if (bench / rel).exists():
            raise FileExistsError(f"the stand-in would edit {rel}")
        (bench / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, bench / rel)
    man = harness.manifest()
    entries = json.loads((STANDIN / "entries.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        man[key] = man[key] + entries[key]
    cells = [w["name"] for w in entries["workloads"]]
    for m in man["end_to_end"]:
        if m["name"] in entries["reports"] and "workloads" in m:
            m["workloads"] = m["workloads"] + cells
    (dst / "BENCHMARK.json").write_text(json.dumps(man, indent=2) + "\n")
    return harness.manifest(dst), dst


@pytest.fixture(scope="session")
def standin(tmp_path_factory):
    """(manifest, root) of the stand-in checkout."""
    return build_standin(tmp_path_factory.mktemp("standin"))


@pytest.fixture
def cell_at(request):
    """cell_at(where, name): the harness.Cell of a cell of this checkout's
    manifest with the pending entries ("repo") or of the stand-in's."""
    from phbench import harness

    def at(where, name):
        if where == "repo":
            return harness.Cell(name, harness.with_pending())
        man, root = request.getfixturevalue("standin")
        return harness.Cell(name, man, root)
    return at
