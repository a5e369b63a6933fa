"""Native C++ data-file parser: correctness vs numpy, error paths, and a
performance sanity factor (SURVEY §2.11 item 7)."""

import io
import timeit

import numpy as np
import pytest

from tpusph import native


@pytest.fixture(scope="module")
def lib_available():
    if native.get_lib() is None:
        pytest.skip("g++ unavailable; numpy fallback covers this path")
    return True


def test_parse_matches_numpy(lib_available):
    rng = np.random.default_rng(0)
    mat = rng.normal(size=(500, 8)).astype(np.float32)
    rows = []
    for i, r in enumerate(mat):
        line = " ".join(f"{v:.8g}" for v in r)
        if i % 50 == 3:
            line += "  # trailing comment"
        rows.append(line)
        if i % 97 == 0:
            rows.append("")          # blank line
        if i % 61 == 0:
            rows.append("# full-line comment")
    text = "\n".join(rows)
    got = native.parse_table(text, 500, 8)
    ref = np.loadtxt(io.StringIO(text), comments="#")
    np.testing.assert_allclose(got, ref.astype(np.float32), rtol=1e-6)


def test_parse_malformed_raises(lib_available):
    with pytest.raises(ValueError, match="malformed|expected"):
        native.parse_table("1 2 3\n4 banana 6\n", 2, 3)
    with pytest.raises(ValueError, match="expected 3 data rows"):
        native.parse_table("1 2 3\n", 3, 3)


def test_parse_speed_factor(lib_available):
    """The native parser must beat numpy.loadtxt clearly (it's the reason
    it exists). Loose 3x gate to stay robust on loaded CI machines."""
    rng = np.random.default_rng(1)
    mat = rng.normal(size=(60_000, 8))
    text = "\n".join(" ".join(f"{v:.8g}" for v in r) for r in mat)

    # the fastest of 5 runs (timeit's clock is time.perf_counter): the run
    # least disturbed by whatever else the machine is doing
    t_native = min(timeit.repeat(lambda: native.parse_table(text, 60_000, 8),
                                 number=1, repeat=5))
    t_numpy = min(timeit.repeat(lambda: np.loadtxt(io.StringIO(text)),
                                number=1, repeat=5))

    assert t_native < t_numpy / 3.0, (t_native, t_numpy)


def test_native_dump_formatter_matches_python():
    """dumpwriter.cpp must format byte-for-byte like the Python fallback
    ("%.8g" floats, "%d" ids) so dump files are identical either way."""
    from tpusph import native
    rng = np.random.default_rng(0)
    mat = np.column_stack([
        np.arange(1, 201, dtype=np.float32),
        rng.integers(1, 5, 200).astype(np.float32),
        rng.normal(0, 1e3, 200).astype(np.float32),
        rng.uniform(1e-9, 1e9, 200).astype(np.float32),
    ])
    ints = [0, 1]
    txt = native.format_dump_rows(mat, ints)
    if txt is None:
        import pytest
        pytest.skip("no native toolchain")
    exp = []
    for row in mat:
        parts = [("%d" % row[i]) if i in ints else ("%.8g" % row[i])
                 for i in range(mat.shape[1])]
        exp.append(" ".join(parts))
    assert txt == "\n".join(exp) + "\n"
