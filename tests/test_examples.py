# SPDX-License-Identifier: CECILL-2.1
"""Every shipped example must run headless end-to-end (FAST sizes).

Executes each ``examples/ex_*.py`` in-process (so the conftest's fake
8-device CPU mesh applies — ex_04 takes its sharded path) with
BARC4DIP_EX_FAST=1 shrinking the workloads to smoke-test scale, and with an
output directory so the plotting branches execute too.
"""
import runpy
import sys
from pathlib import Path

import matplotlib
import pytest

matplotlib.use("Agg")

EXAMPLES = sorted((Path(__file__).resolve().parents[1] / "examples").glob("ex_*.py"))


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_runs_headless(path, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BARC4DIP_EX_FAST", "1")
    monkeypatch.setattr(sys, "argv", [str(path), str(tmp_path)])
    try:
        runpy.run_path(str(path), run_name="__main__")
    except SystemExit as exc:  # scripts may exit with their return code
        assert not exc.code, f"{path.name} exited with {exc.code}"
    out = capsys.readouterr().out
    assert out.strip(), f"{path.name} produced no output"


def test_ex00_dataset_is_consumable(tmp_path, monkeypatch, capsys):
    """The generated dataset round-trips through the readers and the CLI."""
    monkeypatch.setenv("BARC4DIP_EX_FAST", "1")
    monkeypatch.setattr(sys, "argv", ["ex_00", str(tmp_path)])
    runpy.run_path(str(EXAMPLES[0]), run_name="__main__")
    assert EXAMPLES[0].stem == "ex_00_generate_dataset"

    import barc4dip_tpu as dip

    stack = dip.read_image(str(tmp_path / "speckle_stack.h5"))
    assert stack.ndim == 3 and stack.shape[0] == 4

    from barc4dip_tpu.report.cli import main as cli_main

    rc = cli_main([
        "-s", str(tmp_path / "speckle_stack.h5"), "-n", "0",
        "-f", str(tmp_path / "flat.tif"), "-d", str(tmp_path / "dark.tif"),
    ])
    assert rc == 0
    assert "# Speckle summary" in capsys.readouterr().out


def test_notebook_render(tmp_path, monkeypatch):
    """Every example script renders to a valid notebook."""
    import nbformat

    from examples import make_notebooks as mk

    monkeypatch.setattr(mk, "OUT", tmp_path)
    assert mk.main([]) == 0
    rendered = sorted(tmp_path.glob("ex_*.ipynb"))
    assert len(rendered) == len(sorted(mk.HERE.glob("ex_*.py")))
    nb = nbformat.read(rendered[0], as_version=4)
    assert nb.cells[0].cell_type == "markdown"
    assert "main(out_dir)" in nb.cells[-1].source
    # no cell may reference __file__ (undefined in a kernel)
    for p in rendered:
        for cell in nbformat.read(p, as_version=4).cells:
            if cell.cell_type == "code":
                assert "__file__" not in cell.source, p.name


def test_notebook_executes(tmp_path):
    """One rendered notebook runs end-to-end in a real kernel (catches
    kernel-only failures like __file__ or signature mismatches that the
    structural render test cannot)."""
    import nbformat
    from nbclient import NotebookClient

    from examples import make_notebooks as mk

    nb = mk.build_notebook(mk.HERE / "ex_03_fourier_analysis.py")
    # force FAST sizes + the CPU backend inside the kernel
    nb.cells.insert(1, nbformat.v4.new_code_cell(
        "import os\n"
        "os.environ['BARC4DIP_EX_FAST'] = '1'\n"
        f"os.environ['BARC4DIP_TPU_ROOT'] = {str(mk.HERE.parent)!r}\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
    ))
    client = NotebookClient(
        nb, timeout=300, resources={"metadata": {"path": str(tmp_path)}}
    )
    client.execute()
    # the run cell produced stdout (the printed grain numbers)
    assert any(
        out.get("name") == "stdout"
        for cell in nb.cells if cell.cell_type == "code"
        for out in cell.get("outputs", [])
    )
