"""The in-repo parameter-file reader and writer (utils.params.yaml_load /
yaml_dump) against PyYAML, which stays a test-only reference."""

import ast
import glob
import os

import numpy as np
import pytest

from cmacionize_tpu.utils.params import ParameterFile, yaml_dump, yaml_load

yaml = pytest.importorskip("yaml")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _benchmark_files():
    return sorted(
        glob.glob(os.path.join(REPO, "benchmarks", "*.param"))
        + glob.glob(os.path.join(REPO, "benchmarks", "*.yml")))


def _cli_test_texts():
    """Parameter and tracker texts written by tests/test_cli_api.py: the
    ``param_text = ...`` constants, ``.write_text(<constant>)`` arguments
    and the Voronoi RHD template."""
    path = os.path.join(REPO, "tests", "test_cli_api.py")
    with open(path) as handle:
        tree = ast.parse(handle.read())
    texts = {}
    for node in ast.walk(tree):
        value = None
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "param_text"
                for t in node.targets):
            value = node.value
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "write_text" and node.args):
            value = node.args[0]
        if isinstance(value, ast.Constant) and isinstance(value.value, str):
            texts[f"line{node.lineno}"] = value.value
    import importlib.util

    spec = importlib.util.spec_from_file_location("_cli_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    texts["voronoi_rhd"] = module._voronoi_rhd_param(0.00282)
    return texts


_CLI_TEXTS = _cli_test_texts()


@pytest.mark.parametrize(
    "path", _benchmark_files(), ids=lambda p: os.path.basename(p))
def test_benchmark_files_match_pyyaml(path):
    with open(path) as handle:
        text = handle.read()
    assert yaml_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("name", sorted(_CLI_TEXTS))
def test_cli_test_texts_match_pyyaml(name):
    text = _CLI_TEXTS[name]
    assert yaml_load(text) == yaml.safe_load(text)


def test_scalar_resolution_matches_pyyaml():
    text = (
        "a: [1, 'x, y', \"q\\\"z\", 1e6, 1.e+6, 0.5, .inf, yes, Off, ~, "
        "007, 0x1f, -2]\n"
        "b:\n- [1. pc, 2 pc]\n- x\n"
        "c:\n"
        "d: 'it''s' # comment\n"
        "e: x#y\n"
        "f: []\n"
        "g:\n  h:\n    i: 1.5e-3 m\n"
    )
    assert yaml_load(text) == yaml.safe_load(text)


def test_used_values_round_trip(tmp_path):
    """The used-values dump reads back (with both readers) to exactly the
    values the run used, defaults included."""
    path = os.path.join(REPO, "benchmarks", "lexingtonHII40.param")
    params = ParameterFile(path)
    params.get_physical_vector("SimulationBox:anchor", "length")
    params.get_int_vector("DensityGrid:number of cells")
    params.get_bool("TemperatureCalculator:do temperature calculation")
    params.get_number("IonizationSimulation:number of photons")
    params.get_string("DensityGridWriter:prefix")
    # defaults of every kind the dump must keep apart
    params.get_value("Extra:text that looks true", "true")
    params.get_value("Extra:text with colon", "a: b")
    params.get_value("Extra:float", 1.0e-6)
    params.get_value("Extra:big float", 1.0e300)
    params.get_value("Extra:int", -3)
    params.get_value("Extra:bool", False)
    params.get_value("Extra:none", None)
    params.get_value("Extra:list", [1.5, "2 pc", True])
    params.get_value("Extra:numpy", np.float64(2.5))
    out = tmp_path / "used.yml"
    params.write_used_values(str(out))
    text = out.read_text()
    expected = {}
    for key, value in params.used_values().items():
        node = expected
        parts = key.split(":")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    assert yaml_load(text) == expected
    assert yaml.safe_load(text) == expected
    reread = ParameterFile(str(out))
    assert reread.get_int_vector("DensityGrid:number of cells") == [64] * 3
    assert reread.get_string("Extra:text that looks true") == "true"


def test_yaml_dump_sorts_and_nests():
    tree = {"b": {"y": 1, "x": [1, 2]}, "a": "v"}
    assert yaml_dump(tree) == "a: v\nb:\n  x: [1, 2]\n  y: 1\n"
