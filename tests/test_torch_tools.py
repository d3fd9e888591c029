"""The port's host tools (tools/phash_test.py, position_test.py,
gen_bluenoise.py) against the JAX package's: the same output and exit
code on generated images, and the same blue-noise ranks."""
import io

import numpy as np
import pytest
from PIL import Image

from rupphash_tpu.tools import gen_bluenoise as ref_bluenoise
from rupphash_tpu.tools import phash_test as ref_phash_test
from rupphash_tpu.tools import position_test as ref_position_test
from rupphash_tpu_torch.tools import gen_bluenoise, phash_test, position_test


def _same_run(ours, ref, argv, capsys):
    """Exit code, stdout and stderr of both mains; the usage lines name
    each package's module."""
    rc = ours.main(argv)
    out = capsys.readouterr()
    ref_rc = ref.main(argv)
    ref_out = capsys.readouterr()
    assert rc == ref_rc
    assert out.out == ref_out.out
    assert out.err == ref_out.err.replace("rupphash_tpu.",
                                          "rupphash_tpu_torch.")
    return rc, out


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    rng = np.random.default_rng(31)
    small = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    p = tmp_path_factory.mktemp("tools") / "photo.png"
    Image.fromarray(small).resize((320, 240), Image.BILINEAR).save(p)
    return p


def _jpeg_with_gps(path, gps=True):
    rng = np.random.default_rng(3)
    im = Image.fromarray(rng.integers(0, 256, (48, 64, 3), np.uint8))
    ex = Image.Exif()
    ex[0x8769] = {36867: "2024:03:01 10:00:00"}
    if gps:
        ex[0x8825] = {1: "N", 2: (60.0, 10.0, 11.64), 3: "E",
                      4: (24.0, 56.0, 18.24), 5: 0, 6: 26.0,
                      7: (8.0, 30.0, 0.0), 29: "2024:03:01"}
    buf = io.BytesIO()
    im.save(buf, format="JPEG", exif=ex)
    path.write_bytes(buf.getvalue())
    return path


@pytest.mark.parametrize("flags", [[], ["--pdq"]])
def test_phash_test_prints_the_references(photo, flags, capsys):
    rc, out = _same_run(phash_test, ref_phash_test, [str(photo), *flags],
                        capsys)
    assert rc == 0 and "Standard pHash (Hex)" in out.out
    assert ("PDQ (Hex)" in out.out) == bool(flags)


@pytest.mark.parametrize("argv", [[], ["/no/such/image.png"]],
                         ids=["usage", "missing"])
def test_phash_test_errors_as_the_reference(argv, capsys):
    rc, out = _same_run(phash_test, ref_phash_test, argv, capsys)
    assert rc == 1 and out.err


@pytest.mark.parametrize("flags", [[], ["--gpstime"]])
def test_position_test_prints_the_references(tmp_path, flags, capsys):
    img = _jpeg_with_gps(tmp_path / "gps.jpg")
    rc, out = _same_run(position_test, ref_position_test,
                        [*flags, str(img)], capsys)
    assert rc == 0 and "Sun Altitude" in out.out
    assert "Helsinki to Tampere Distance: 161.2" in out.out


@pytest.mark.parametrize("case", ["usage", "no-gps"])
def test_position_test_errors_as_the_reference(tmp_path, case, capsys):
    argv = [] if case == "usage" else \
        [str(_jpeg_with_gps(tmp_path / "plain.jpg", gps=False))]
    rc, out = _same_run(position_test, ref_position_test, argv, capsys)
    assert rc == 1 and out.err


@pytest.mark.parametrize("side,sigma", [(8, 1.9), (16, 1.9), (12, 1.5)])
def test_blue_noise_ranks_are_the_references(side, sigma):
    got = gen_bluenoise.generate_rank_tile(side, sigma=sigma)
    assert np.array_equal(got, ref_bluenoise.generate_rank_tile(side,
                                                                sigma=sigma))
    assert sorted(got.ravel().tolist()) == list(range(side * side))


def test_gen_bluenoise_writes_the_ports_asset(tmp_path, monkeypatch,
                                              capsys):
    """main() writes assets/blue-noise-256.npy beside the port's own
    tools package (here a stand-in tree, with a small tile)."""
    import rupphash_tpu_torch

    pkg = tmp_path / "pkg"
    (pkg / "tools").mkdir(parents=True)
    small = gen_bluenoise.generate_rank_tile(8)
    monkeypatch.setattr(gen_bluenoise, "__file__",
                        str(pkg / "tools" / "gen_bluenoise.py"))
    monkeypatch.setattr(gen_bluenoise, "generate_rank_tile",
                        lambda side, progress=False: small)
    gen_bluenoise.main()
    written = np.load(pkg / "assets" / "blue-noise-256.npy")
    assert written.dtype == np.uint16 and np.array_equal(written, small)
    assert "wrote" in capsys.readouterr().out
    shipped = np.load(next(iter(rupphash_tpu_torch.__path__))
                      + "/assets/blue-noise-256.npy")
    assert shipped.shape == (256, 256) and shipped.dtype == np.uint16
