"""Two optimizer steps of the tiny U-Net with the flagship's fp16 codec, in
the port against the JAX package (the harness and the tolerances' reasons
are in ``test_torch_train_step.py``; this case lives in its own file so
that each file's JAX compile stays short)."""

import numpy as np

from test_torch_train_step import _close, _params_agree, _run_both


def test_two_steps_fp16_codec_match_jax_up_to_lattice_flips():
    jout, tout = _run_both("float16")
    np.testing.assert_allclose(tout["losses"], jout["losses"], rtol=1e-4)
    _close(jout["batch_stats"], tout["batch_stats"], 1e-4, 1e-6)
    _params_agree(jout, tout, max_share=2e-2)
