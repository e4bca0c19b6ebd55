"""The control-file reader (oisat.control) decodes the shipped recipes
exactly as YAML does, and refuses what the flat format does not hold."""

import glob
import os

import pytest

from oisat.control import parse_control, read_control

RUN_DIR = os.path.join(os.path.dirname(__file__), "..", "run")
CONTROL_FILES = sorted(os.path.basename(p)
                       for p in glob.glob(os.path.join(RUN_DIR, "control*.yml")))


def test_every_recipe_is_covered():
    assert len(CONTROL_FILES) == 7


@pytest.mark.parametrize("name", CONTROL_FILES)
def test_control_file_matches_yaml(name):
    yaml = pytest.importorskip("yaml")

    path = os.path.join(RUN_DIR, name)
    with open(path) as f:
        want = yaml.safe_load(f)
    assert read_control(path) == want


def test_control_values_decode_like_yaml():
    text = ("a: 1\nb: 1.5\nc: true\nd: False\ne: ~\nf:\ng: 2019-07\n"
            "h: '50'  # quoted stays text\ni: \"x # y\"\nj: /p/q r  # c\n"
            "k: 1.0e-07\nl: it's\n")
    assert parse_control(text) == {
        "a": 1, "b": 1.5, "c": True, "d": False, "e": None, "f": None,
        "g": "2019-07", "h": "50", "i": "x # y", "j": "/p/q r", "k": 1e-7,
        "l": "it's"}


@pytest.mark.parametrize("text", ["a:\n  b: 1\n", "- a\n", "a: [1, 2]\n",
                                  "just text\n"])
def test_control_rejects_nested_values(text):
    with pytest.raises(ValueError):
        parse_control(text)
