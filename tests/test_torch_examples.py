"""The paper's entry points on the port: each ``examples/*_torch.py``
prints what its JAX original prints, on the CPU.

Each case runs the JAX package's example and its port (``--device cpu``)
in this process through ``runpy`` with ``sys.argv`` set, captures their
standard output and compares the two texts with the clock's readings
masked (``chip_smoke.clock_masked``: EXPLAIN ANALYZE's ``*time_s`` fields
and scenario 4's ``--explain`` phase lines).  Ids, counts, MB loaded,
precision and the modeled EBS seconds stay compared.  ``chip_smoke.py``
phase 16 holds the ports on the card to the same scripts on the CPU.

About 45 s on one CPU worker.
"""

import contextlib
import io
import os
import runpy
import sys

import jax  # noqa: F401  (the originals' package; CPU here)
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import clock_masked  # noqa: E402

# (original, arguments both sides take): the six scripts, scenario 4 with
# --explain on the host and on the device and mesh backends, scenario 5 on
# the host and device backends
CASES = [
    ("quickstart", []),
    ("scenario2_adversarial", []),
    ("scenario3_attention_alignment", []),
    ("scenario4_interactive_session", ["--explain"]),
    ("scenario4_interactive_session", ["--backend", "device"]),
    ("scenario4_interactive_session", ["--backend", "mesh"]),
    ("scenario5_model_iteration", []),
    ("scenario5_model_iteration", ["--backend", "device"]),
    ("scenario6_discrepancy", []),
]


def stdout_of(script: str, args: list) -> str:
    """``examples/<script>.py`` run as ``__main__`` with ``args``."""
    path = os.path.join(REPO, "examples", script + ".py")
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [path, *args]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved
    return out.getvalue()


def test_clock_masked_masks_only_the_clock():
    text = ("  TopK(k=25)  [verified=72 bound_time_s=0.3263 "
            "verify_time_s=1.2e-05 load_fraction=0.12]\n"
            "          phases: bounds    0.0 ms | verify    5.1 ms\n"
            "  disk: 579 files, 37.95 MB read (modeled EBS 0.53s)\n")
    assert clock_masked(text) == (
        "  TopK(k=25)  [verified=72 bound_time_s=<clock> "
        "verify_time_s=<clock> load_fraction=0.12]\n"
        "          phases: <clock>\n"
        "  disk: 579 files, 37.95 MB read (modeled EBS 0.53s)\n")


@pytest.mark.parametrize("script,args", CASES,
                         ids=[f"{s}{''.join(a)}" for s, a in CASES])
def test_port_example_prints_what_the_original_prints(script, args):
    want = stdout_of(script, args)
    got = stdout_of(script + "_torch", [*args, "--device", "cpu"])
    assert len(want.splitlines()) >= 4
    assert clock_masked(got) == clock_masked(want)
