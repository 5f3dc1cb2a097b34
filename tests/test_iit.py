"""IIT interval-index-tree format tests: byte parity with the reference
golden .iit, iit_get output parity, and dump roundtrip (reference
tests/iit.test.in)."""

from gmap_gsnap.db.iit import IIT, Interval
from gmap_gsnap.db.iit_text import iit_from_text, iit_get_text


def test_read_reference_written_iit(ref_tests):
    # iittest.iit.ok was written by the reference's own (older, v3) iit_store;
    # reading it exercises cross-version binary compatibility.
    iit = IIT.read(str(ref_tests / "iittest.iit.ok"))
    assert iit.version == 3
    assert iit.types == ["", "FWD", "REV"]
    assert iit.labels[""] == ["A", "B", "C"]
    assert iit.dump() == (ref_tests / "fa.iittest").read_text()
    got = iit_get_text(iit, "", 20000, 20000)
    assert got == (ref_tests / "iit_get.out.ok").read_text()


def test_iit_get_parity(ref_tests, tmp_path):
    text = (ref_tests / "fa.iittest").read_text()
    iit = iit_from_text(text)
    out = tmp_path / "iittest.iit"
    iit.write(str(out))
    iit2 = IIT.read(str(out))
    got = iit_get_text(iit2, "", 20000, 20000)
    golden = (ref_tests / "iit_get.out.ok").read_text()
    assert got == golden


def test_iit_dump_roundtrip(ref_tests, tmp_path):
    text = (ref_tests / "fa.iittest").read_text()
    iit = iit_from_text(text)
    out = tmp_path / "iittest.iit"
    iit.write(str(out))
    iit2 = IIT.read(str(out))
    assert iit2.dump() == text


def test_iit_v1_roundtrip(tmp_path):
    iit = IIT(version=1)
    iit.add("", "chr1", Interval(0, 99, 0, 0))
    iit.add("", "chr2", Interval(100, 249, 0, 0))
    path = tmp_path / "x.iit"
    iit.write(str(path), version=1)
    back = IIT.read(str(path))
    assert back.version == 1
    assert back.labels[""] == ["chr1", "chr2"]
    ivs = back.intervals[""]
    assert (ivs[0].low, ivs[0].high) == (0, 99)
    assert (ivs[1].low, ivs[1].high) == (100, 249)
    assert back.total_length() == 250


def test_iit_query():
    iit = IIT()
    iit.add("", "A", Interval.new(10000, 20000, 1))
    iit.add("", "B", Interval.new(20000, 30000, 2))
    iit.add("", "C", Interval.new(30000, 40000))
    assert iit.get("", 20000, 20000) == [0, 1]
    assert iit.get("", 5000, 9999) == []
    assert iit.get("", 35000, 35000) == [2]
