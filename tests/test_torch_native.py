"""The port's native C++ LIBSVM parser (``tpu_sgd_torch/utils/native``)
against the JAX package's parsers on the CPU: the parser cases of
``tests/test_native.py`` (the row gather is not ported: the streamed
drivers gather with ``torch.index_select``).  Everything parsed is exact:
labels, row and column indices, values and the largest index.  The
library is compiled from the port's own copy of the source at first use;
``mlutils.last_reader`` shows which reader ran."""

import numpy as np
import pytest

from tpu_sgd.utils import mlutils as jml
from tpu_sgd_torch.utils import mlutils as tml
from tpu_sgd_torch.utils import native

TEXT = "1 1:1.5 3:2.0\n0 2:-0.5  # comment\n\n1 1:0.25 2:1.0 3:-1.0\n"


@pytest.fixture(scope="module")
def parse():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.exists()
    return native.parse_libsvm


def test_native_matches_python(parse, tmp_path):
    p = tmp_path / "d.txt"
    p.write_text(TEXT)
    got = parse(str(p))
    for ref in (jml._parse_libsvm_python(str(p)),
                tml._parse_libsvm_python(str(p))):
        for a, b in zip(got[:4], ref[:4]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert got[4] == ref[4] == 3


def test_native_rejects_zero_index(parse, tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("1 0:5.0\n")
    with pytest.raises(IOError):
        parse(str(p))
    # the loader then gives the Python parser's error, as the JAX one does
    with pytest.raises(ValueError, match="invalid 0 index"):
        tml.load_libsvm_file(str(p))
    assert tml.last_reader == "python"
    with pytest.raises(ValueError, match="invalid 0 index"):
        jml.load_libsvm_file(str(p))


@pytest.mark.parametrize("bad", ["1 5:\n", "1 5: 2.0\n", "1 x:2\n"])
def test_native_rejects_malformed_tokens(parse, tmp_path, bad):
    p = tmp_path / "bad.txt"
    p.write_text(bad)
    with pytest.raises(IOError):
        parse(str(p))


def test_native_large_random_roundtrip(parse, tmp_path):
    r = np.random.default_rng(0)
    n, d = 200, 40
    X = (r.random((n, d)) * (r.random((n, d)) < 0.1)).astype(np.float32)
    X[:, -1] = 1.0  # keep the largest index stable
    y = (r.random(n) < 0.5).astype(np.float32)
    p = str(tmp_path / "big.txt")
    tml.save_as_libsvm_file(p, X, y)
    X2, y2 = tml.load_libsvm_file(p)
    assert tml.last_reader == "native"
    np.testing.assert_allclose(X2, X, rtol=1e-4)
    np.testing.assert_array_equal(y2, y)
    jX, jy = jml.load_libsvm_file(p)
    np.testing.assert_array_equal(X2, jX)
    np.testing.assert_array_equal(y2, jy)
    # the CSR triple and a directory of part files go through it too
    (vals, cols, indptr), y3, dd = tml.load_libsvm_file(p, dense=False)
    assert tml.last_reader == "native" and dd == d
    np.testing.assert_array_equal(y3, y)
    q = str(tmp_path / "parts")
    tml.save_as_libsvm_file(q, X, y, num_partitions=3)
    X4, y4 = tml.load_libsvm_file(q)
    assert tml.last_reader == "native"
    np.testing.assert_array_equal(X4, X2)
    np.testing.assert_array_equal(y4, y2)


def test_library_name_follows_the_source_and_flags(monkeypatch):
    """Other flags (or an edited source) name another library, so a stale
    one is never loaded."""
    path = native.library_path()
    assert path.name.startswith("libsvm_parser-") and path.suffix == ".so"
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != path
