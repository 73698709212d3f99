"""The fidelity report's cases of ``tests/test_torch_fidelity.py`` on the
textured demo world (``--world textured``), where the texture levers
change pixels. A file of its own, so that the two worlds' JAX frames
compile on two test workers."""

import pytest

from test_torch_fidelity import (jax_frames, report,  # noqa: F401
                                 test_frames_match_the_jax_engine,
                                 test_report_rows_and_files,
                                 test_rows_match_the_rows_of_the_jax_frames)


@pytest.fixture(scope="module")
def world():
    return "textured"
