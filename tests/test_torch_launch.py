"""Every kernel wrapper launches with its tensor's device current.

The C entry points read the device from the runtime (its SM count, the
kernel's shared-memory attribute) while the wrappers hand them the
stream of the tensor's device; with a tensor on cuda:1 and cuda:0
current the two would disagree.  All six entry points go through
ops/_build.launch, which makes the tensor's device current around the
call.  Here on the CPU: the wrappers' sources are read for any call
that bypasses it, and launch itself runs against a stand-in library
with torch.cuda.device recorded.  On two cards,
tests/test_torch_cuda.py::test_kernels_launch_on_the_tensors_device
runs the kernels themselves on cuda:1 with cuda:0 current."""
import ast
import pathlib
from types import SimpleNamespace

import pytest
import torch

from rupphash_tpu_torch.ops import _build

OPS = pathlib.Path(_build.__file__).resolve().parent
WRAPPERS = {"pdq_cuda.py": ["rupp_pdq_hash"],
            "pdq_hybrid.py": ["rupp_pdq_coeffs"],
            "hamming_cuda.py": ["rupp_hamming_rowcount",
                                "rupp_hamming_rowcount_mma",
                                "rupp_hamming_extract"],
            "restack.py": ["rupp_restack"]}


def _launch_calls(tree):
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "launch"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "_build"):
            yield node


def test_every_entry_point_is_reached_through_launch():
    assert sorted(e for es in WRAPPERS.values() for e in es) == \
        sorted(_build._SIGNATURES)
    for name, entries in WRAPPERS.items():
        tree = ast.parse((OPS / name).read_text())
        direct = [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                  and n.attr.startswith("rupp_")]
        assert direct == [], f"{name} calls {direct} around _build.launch"
        assert "stream_ptr" not in (OPS / name).read_text(), name
        launched = sorted(c.args[2].value for c in _launch_calls(tree))
        assert launched == sorted(entries), name


@pytest.fixture
def recorded(monkeypatch):
    """torch.cuda.device records its entries and exits; the library is a
    stand-in whose entry points record the device current at the call."""
    log = []

    class Current:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            log.append(("enter", self.dev))

        def __exit__(self, *exc):
            log.append(("exit", self.dev))

    class Lib:
        def __getattr__(self, entry):
            def call(*args):
                log.append(("call", entry, args))
                return 7 if entry == "rupp_fails" else 0
            return call

        def rupp_cuda_error_string(self, err):
            return b"simulated"

    monkeypatch.setattr(torch.cuda, "device", Current)
    monkeypatch.setattr(_build, "load", lambda: SimpleNamespace(lib=Lib()))
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 4242)
    return log


def _wrapper():
    def fn():
        pass
    fn.launches = 0
    return fn


def test_launch_makes_the_tensors_device_current(recorded):
    on = SimpleNamespace(device=torch.device("cuda", 1))
    fn = _wrapper()
    _build.launch(fn, "some_kernel", "rupp_pdq_hash", on, 5, 6)
    cuda1 = torch.device("cuda", 1)
    assert recorded == [("enter", cuda1),
                        ("call", "rupp_pdq_hash", (5, 6, 4242)),
                        ("exit", cuda1)]
    assert fn.launches == 1


def test_a_failed_launch_raises_and_is_not_counted(recorded):
    fn = _wrapper()
    on = SimpleNamespace(device=torch.device("cuda", 3))
    with pytest.raises(RuntimeError, match="some_kernel: CUDA error 7"):
        _build.launch(fn, "some_kernel", "rupp_fails", on)
    assert recorded[-1] == ("exit", torch.device("cuda", 3))
    assert fn.launches == 0
