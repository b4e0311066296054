"""The port's public surface covers bild_tpu's: every public name of
`bild_tpu`, `bild_tpu.parallel` and `bild_tpu.experimental` exists in
`bild_tpu_torch`, apart from what ROADMAP.md lists under "Do not port"
(no public name since `experimental` was ported)."""
import pytest

import bild_tpu as bj
import bild_tpu_torch as bt

DO_NOT_PORT = set()


@pytest.mark.parametrize("name", ["", "parallel", "experimental"])
def test_public_names_exist_in_the_port(name):
    ref = getattr(bj, name) if name else bj
    port = getattr(bt, name) if name else bt
    public = {n for n in dir(ref) if not n.startswith("_")} - DO_NOT_PORT
    assert sorted(public - set(dir(port))) == []


def test_util_is_profiles():
    assert bt.util is bt.profiles and bj.util is bj.profiles
