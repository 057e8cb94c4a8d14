"""The in-repo YAML reader and writer against PyYAML.

Every config a test writes with ``yaml.safe_dump`` is also read back by
``yamlio`` and compared (``tests/conftest.py``); here the example configs,
hand-written texts in the subset and the writer are checked.
"""

import glob
import math
import os

import numpy as np
import pytest
import yaml

from nemo_tpu.utils import yamlio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*.yml")))


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[os.path.basename(p) for p in EXAMPLES])
def test_examples_match_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert yamlio.load(text) == yaml.safe_load(text)


TEXTS = {
    "scalars": "a: 1e5\nb: 1.0e5\nc: 1.0e+5\nd: 0x1F\ne: 010\nf: yes\n"
               "g: ~\nh: 'it''s'\ni: \"x\\ty\\u00e9\"\nk: 1:30\nl: .inf\n"
               "m: -.Inf\nn: 1_000\no: -0.5\np: .5\nq: 0b101\nr: Off\n"
               "s: NULL\nt: 4.95e-5\n",
    "nesting": "x:\n- a\n- b: 1\n  c: [1,\n     2]  # comment\n- - n1\n"
               "  - n2\ny: {a: 1,  # c\n    b: 'q # not'}\n"
               "z: plain text  with  spaces\n"
               "w: long line\n  continues here\n",
    "keys": "1: one\n'2': two\n\"three\": 3\n",
    "blocks": "# head\n---\na:\n  b:\n    c: d\n  e: f\ng:\nh: []\n"
              "i: {}\nj: [a, {k: [], l: {m: n}}]\n",
    "quoted": "key: \"multi\n  line\"\nk2: 'a\n\n  b'\n",
    "list": "- 1\n- [2, 3]\n-\n  - 4\n",
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_texts_match_pyyaml(name):
    assert yamlio.load(TEXTS[name]) == yaml.safe_load(TEXTS[name])


VALUES = {
    "strings": ["a  b", " lead", "trail ", "x: y", "#c", "a #b", "[x]",
                "1", "1.5", "true", "null", "", "new\nline", "tab\tx",
                "é", "-x", "a,b", "it's", 'say "hi"', "{b}", "~"],
    "floats": [1e-05, 1e16, 0.1, -2.5, math.inf, -math.inf, 3.0, 2.0e14],
    "mixed": {"n": None, "b": [True, False], "e": {}, "l": [],
              "nest": [{"a": [1, {"b": 2}]}, [[]], [[1, 2], {}]],
              3: "int key", "tiles": [{"tileName": "1_0_0",
                                       "RADecSection": [1.5, 2.25,
                                                        -3.0, 4.0]}]},
}


@pytest.mark.parametrize("name", sorted(VALUES))
def test_dump_round_trips(name):
    text = yamlio.dump(VALUES[name])
    assert yaml.safe_load(text) == VALUES[name]
    assert yamlio.load(text) == VALUES[name]
    assert yamlio.load(yaml.safe_dump(VALUES[name])) == VALUES[name]


@pytest.mark.parametrize("text", ["a: &x 1\nb: *x\n", "a: !!str 1\n",
                                  "a: |\n  b\n", "a: [1, 2\n"])
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError, match="YAML subset"):
        yamlio.load(text)


def test_numpy_scalars_dump_as_numbers():
    text = yamlio.dump({"a": np.float64(0.25), "b": np.int32(7)})
    assert yamlio.load(text) == {"a": 0.25, "b": 7}
