"""profile_card.py --rows instruments the committed kernel sources through
the per-row hook of their row loops (ROW_PROFILE_BEGIN / ROW_PROFILE_END):
each edit lands exactly once.  The CPU half; the profile itself runs on
the card."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def profile_card():
    sys.path.insert(0, str(ROOT))
    import profile_card
    return profile_card


@pytest.mark.parametrize("name,loops", [("sc_decode", 2),
                                        ("scl_decode", 1)])
def test_instrument_lands_each_edit_once(profile_card, tmp_path, name,
                                         loops):
    """The copy is the prelude, the source unchanged, then the readers,
    each once; the prelude's macros come first, so the source's empty
    ones behind the guard are skipped; every row loop (A: the wide rows
    and the narrow runs; B and C: one) calls the hook in pairs."""
    src = (ROOT / "modem_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    out = profile_card.instrument(name, tmp_path)
    assert out == tmp_path / f"{name}.cu"
    text = out.read_text()
    assert text == profile_card.PRELUDE + src + profile_card.TAIL
    for part in (profile_card.PRELUDE, profile_card.TAIL, src):
        assert text.count(part) == 1
    assert text.count(profile_card.GUARD) == 1
    for define in profile_card.DEFINES:
        assert text.count(define) == 2
        assert text.index(define) < text.index(profile_card.GUARD)
    begin, end = profile_card.HOOKS
    assert text.count(begin) == loops
    assert text.count(end) == loops + 2        # the calls and two defines


def test_instrument_refuses_a_source_without_the_hook(profile_card, tmp_path,
                                                      monkeypatch):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "plain.cu").write_text(
        "__global__ void k(int* x) {\n"
        "  for (int i = 0; i < 4; ++i) x[i] = i;\n"
        "}\n")
    monkeypatch.setattr(profile_card._build, "CSRC", tmp_path / "csrc")
    with pytest.raises(RuntimeError, match="row-profile hook"):
        profile_card.instrument("plain", tmp_path)
