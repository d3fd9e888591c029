"""The port's multi-process layer (rupphash_tpu_torch/parallel/multihost.py)
on torch.distributed: two real processes under gloo on the CPU mirror
both tests of tests/test_multihost.py, and the file partition equals the
reference's.  Every wait is bounded: the process group times out after
60 s and each test kills its workers after 90 s."""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rupphash_tpu.ops import pdq_jax
from rupphash_tpu.parallel import multihost as ref_multihost
from rupphash_tpu.pipeline import decode as ref_decode
from rupphash_tpu_torch import device
from rupphash_tpu_torch.parallel import multihost

ROOT = Path(__file__).resolve().parents[1]

_INIT = """
    import datetime, os, sys
    import numpy as np
    import torch.distributed as dist
    pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=pid, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    from rupphash_tpu_torch.parallel import multihost
    assert multihost.process_info() == (pid, 2)
"""

_WORKER = textwrap.dedent(_INIT + """
    files = [f"f{i:03d}" for i in range(16)]
    assert multihost.shard_files(files, by="stride") == files[pid::2]

    # unequal shards, as the hash partition gives them: the gather pads
    # to the largest, trims per rank and concatenates in rank order
    n_local = 8 if pid == 0 else 5
    rng = np.random.default_rng(pid)
    local = rng.integers(0, 256, (n_local, 32), dtype=np.uint8)
    local_var = np.repeat(local[:, None, :], 8, axis=1)
    local_low = (np.arange(n_local) % 2 == pid).astype(bool)
    hashes, variants, low = multihost.allgather_hashes(
        local, local_var, local_low)
    assert hashes.shape == (13, 32), hashes.shape
    assert variants.shape == (13, 8, 32), variants.shape
    assert low.shape == (13,) and low.dtype == bool, (low.shape, low.dtype)
    off = 0 if pid == 0 else 8
    assert np.array_equal(hashes[off:off + n_local], local)
    assert np.array_equal(variants[off:off + n_local], local_var)
    assert np.array_equal(low[off:off + n_local], local_low)
    np.savez(os.path.join(outdir, f"proc{pid}.npz"),
             hashes=hashes, variants=variants, low=low)
    dist.destroy_process_group()
    print("worker-ok", pid)
""")

_E2E_WORKER = textwrap.dedent(_INIT + """
    from pathlib import Path
    from rupphash_tpu_torch import device
    from rupphash_tpu_torch.ops import pdq_torch
    from rupphash_tpu_torch.pipeline import decode
    device.pin("cpu")
    corpus = Path(outdir)

    def hash_paths(paths):
        lumas = [decode.prepare_luma_fast(decode.load_image(p)[0])
                 for p in paths]
        return pdq_torch.pdq_hash_batch(np.stack(lumas))["hash"].numpy()

    paths = sorted(corpus.glob("*.png"))
    mine = multihost.shard_files(paths, by="hash")
    shards = [multihost.shard_files(paths, process_index=i,
                                    process_count=2, by="hash")
              for i in range(2)]
    assert mine == shards[pid]
    assert len(shards[0]) != len(shards[1])   # the pad/trim branch
    global_order = shards[0] + shards[1]

    hashes, variants, low = multihost.allgather_hashes(hash_paths(mine))
    assert variants is None and low is None
    assert hashes.shape == (len(paths), 32)
    dist_ = np.unpackbits(hashes[:, None, :] ^ hashes[None, :, :],
                          axis=-1).sum(axis=-1)
    ii, jj = np.nonzero(np.triu(dist_ <= 8, k=1))
    assert len(ii) == 1, (ii, jj)
    pair = {global_order[ii[0]].name, global_order[jj[0]].name}
    assert pair == {"dup_a.png", "dup_b.png"}, pair
    assert len(pair & {p.name for p in shards[0]}) == 1
    if pid == 0:
        assert np.array_equal(hashes, hash_paths(global_order))
    np.save(corpus.parent / f"gathered{pid}.npy", hashes)
    dist.destroy_process_group()
    print("e2e-ok", pid)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(tmp_path, source: str, arg: Path, ok: str, timeout=90):
    script = tmp_path / "worker.py"
    script.write_text(source)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(port), str(arg)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a gloo worker ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"{ok} {pid}" in out


def test_two_process_allgather(tmp_path):
    _run_pair(tmp_path, _WORKER, tmp_path, "worker-ok")
    a = np.load(tmp_path / "proc0.npz")
    b = np.load(tmp_path / "proc1.npz")
    for k in ("hashes", "variants", "low"):
        assert np.array_equal(a[k], b[k])
    assert np.array_equal(a["hashes"][:8], np.random.default_rng(0).integers(
        0, 256, (8, 32), dtype=np.uint8))


def test_two_process_scan_gather_group(tmp_path):
    """Each of two processes decodes and hashes only its hash-partitioned
    shard with the port's plain PDQ; the gathered unequal shards hold the
    planted twins (one in each shard) as their only edge, and equal the
    reference's pdq_jax hashes of the same global list."""
    names = ["dup_a.png", "dup_b.png"] + [f"f{i:02d}.png" for i in range(12)]
    corpus = None
    for k in range(200):
        d = tmp_path / f"c{k:03d}" / "corpus"
        paths = sorted(d / n for n in names)
        s0 = {p.name for p in multihost.shard_files(
            paths, process_index=0, process_count=2, by="hash")}
        if len({"dup_a.png", "dup_b.png"} & s0) == 1 \
                and len(s0) * 2 != len(paths):
            corpus = d
            break
    assert corpus is not None
    corpus.mkdir(parents=True)
    rng = np.random.default_rng(99)
    twin = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    for name in names:
        px = twin if name.startswith("dup_") else \
            rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
        Image.fromarray(px).resize((320, 240), Image.BILINEAR) \
            .save(corpus / name)

    _run_pair(tmp_path, _E2E_WORKER, corpus, "e2e-ok")
    paths = sorted(corpus.glob("*.png"))
    order = [p for i in range(2) for p in ref_multihost.shard_files(
        paths, process_index=i, process_count=2, by="hash")]
    lumas = np.stack([ref_decode.prepare_luma_fast(
        ref_decode.load_image(p)[0]) for p in order])
    want = np.asarray(pdq_jax.pdq_hash_batch(lumas)["hash"])
    for pid in range(2):
        assert np.array_equal(np.load(corpus.parent / f"gathered{pid}.npy"),
                              want)


@pytest.mark.parametrize("by", ["hash", "stride"])
@pytest.mark.parametrize("count", [2, 3, 5])
def test_shard_files_is_the_references(by, count):
    files = [Path(f"/photos/{d}/img_{i:04d}.jpg") for d in ("a", "b")
             for i in range(60)]
    shards = [multihost.shard_files(files, i, count, by=by)
              for i in range(count)]
    assert shards == [ref_multihost.shard_files(files, i, count, by=by)
                      for i in range(count)]
    assert sorted(f for s in shards for f in s) == sorted(files)


def test_one_process_is_an_identity():
    device.pin("cpu")
    assert multihost.process_info() == (0, 1)
    files = ["a", "b", "c"]
    assert multihost.shard_files(files) == files
    h = np.arange(64, dtype=np.uint8).reshape(2, 32)
    out = multihost.allgather_hashes(h)
    assert out[0] is h and out[1] is None and out[2] is None
