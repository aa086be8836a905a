"""The port's package data: every header a CUDA source includes ships with it."""
import re
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "kubeflow_tpu_torch"


def _project():
    return tomllib.loads((ROOT / "pyproject.toml").read_text())


def test_every_include_of_the_kernel_sources_is_package_data():
    globs = _project()["tool"]["setuptools"]["package-data"]["kubeflow_tpu_torch"]
    shipped = {p.resolve() for g in globs for p in PKG.glob(g)}
    sources = sorted((PKG / "csrc").glob("*.cu"))
    assert sources and {p.resolve() for p in sources} <= shipped
    todo, seen = list(sources), set()
    while todo:
        src = todo.pop()
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', src.read_text(), re.M):
            header = (src.parent / name).resolve()
            assert header in shipped, f"{src.name} includes {name}, which the package data lacks"
            if header not in seen:
                seen.add(header)
                todo.append(header)
    assert seen, "no source includes a header: the check saw nothing"


def test_the_port_is_a_package_with_a_torch_extra():
    project = _project()
    include = project["tool"]["setuptools"]["packages"]["find"]["include"]
    assert any(re.fullmatch(p.replace("*", ".*"), "kubeflow_tpu_torch") for p in include)
    assert any(req.split(">")[0].split("=")[0].strip() == "torch"
               for req in project["project"]["optional-dependencies"]["torch"])
