"""PyTorch port, the user entry points (swift_game_engine_tpu_torch/examples:
run_demo, bench_crowd, play) against the repository's examples/ scripts
(CPU).

The frames run on CPU tensors through the kernels' plain twins, at small
sizes and without shadow rays (``--shadow-layers 0``: the shadow walk's
plain twin takes seconds a shade call here); the card runs the defaults
(chip_smoke.py's examples phase). The PNG files are decoded here with
``zlib`` and ``struct`` alone, independently of the writer.
"""

import importlib.util
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from swift_game_engine_tpu_torch.examples import bench_crowd, play, run_demo

sys.path.insert(0, os.path.dirname(__file__))
import torch_sim_worlds as W  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _reference(name):
    """The repository's examples/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_png(path):
    """An 8-bit RGB PNG with filter 0 on every row -> (H, W, 3) uint8;
    every chunk's CRC checked."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, tag
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    assert tag == b"IEND"
    w, h, depth, color, _, _, interlace = header
    assert (depth, color, interlace) == (8, 2, 0)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any(), "a row has a filter other than 0"
    return rows[:, 1:].reshape(h, w, 3)


def test_png_round_trip(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (7, 5, 3), np.uint8)
    run_demo.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)


def test_run_demo_writes_its_frames(tmp_path, capsys):
    """The no-asset DemoScene at 64x36, 2 frames: each PNG decodes to the
    frame Engine.frame gave; the last line reports the player."""
    frames = run_demo.main(["--device", "cpu", "--no-assets", "--frames", "2",
                            "--width", "64", "--height", "36",
                            "--shadow-layers", "0", "--out", str(tmp_path)])
    assert len(frames) == 2
    for i, u8 in enumerate(frames):
        assert u8.shape == (36, 64, 3) and u8.dtype == np.uint8
        np.testing.assert_array_equal(
            read_png(str(tmp_path / f"frame_{i:03d}.png")), u8)
    assert frames[1].std() > 1.0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("scene build:") and "13 entities" in out[0]
    assert out[-1].startswith("player pos:") and "loco state:" in out[-1]


@pytest.mark.parametrize("n", [4, 70])
def test_bench_crowd_builds_the_reference_crowd(n):
    """The same spec, initial state and collision triangles as the
    reference's ``build`` (70 agents: past the separation grid's 64)."""
    jstep, jstate = _reference("bench_crowd").build(n)
    stepper, state = bench_crowd.build(n, device="cpu")
    W.compare_specs(jstep.spec, stepper.spec)
    W.compare_states(jstate, state, atol=0, rtol=0)
    from swift_game_engine_tpu_torch import interop
    ref = interop.local_triangles(jstep.collision, device="cpu")
    for f in ref._fields:
        assert torch.equal(getattr(ref, f), getattr(stepper.collision, f)), f


def test_bench_crowd_prints_its_table(capsys):
    rows = bench_crowd.main(["--device", "cpu", "4"])
    assert [n for n, _ in rows] == [4] and np.isfinite(rows[0][1]) and \
        rows[0][1] > 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == bench_crowd.HEADER and out[1].split()[0] == "4"


def test_play_runs_scripted_frames(capsys):
    u8 = play.main(["--device", "cpu", "--no-assets", "--frames", "2",
                    "--width", "32", "--height", "18", "--shadow-layers",
                    "0"])
    assert u8.shape == (18, 32, 3) and u8.dtype == np.uint8
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "2 frames, ")


def test_ansi_frame_matches_reference():
    """A fixed image of odd height (its last row dropped), with repeated
    cells (whose codes are not repeated)."""
    img = np.random.default_rng(5).integers(0, 4, (5, 6, 3), np.uint8) * 60
    img[:, 3] = img[:, 2]
    assert play.ansi_frame(img) == _reference("play").ansi_frame(img)


def test_interactive_play_needs_a_terminal(monkeypatch):
    monkeypatch.setattr(sys.stdin, "isatty", lambda: False, raising=False)
    with pytest.raises(SystemExit):
        play.main(["--device", "cpu"])


def test_examples_need_a_device_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults use it")
    calls = [lambda: run_demo.main(["--out", str(tmp_path)]),
             lambda: bench_crowd.build(4),
             lambda: play.main(["--frames", "1"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
