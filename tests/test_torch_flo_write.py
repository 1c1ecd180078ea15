"""The port's `.flo` writer (`vfi_tpu_torch.utils.flo.write_flo`) against
the JAX package's: the same bytes; each package's `read_flo` reads the
other's file back exactly; a flow that is not (H, W, 2) raises."""

import numpy as np
import pytest

from vfi_tpu.utils import flo as jflo
from vfi_tpu_torch.utils import flo


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_write_flo_is_byte_equal_to_jax(tmp_path, dtype):
    rng = np.random.default_rng(3)
    fl = (rng.standard_normal((7, 11, 2)) * 20).astype(dtype)
    fl[2, 3] = 1e10        # an unknown-flow sentinel travels as it is
    ours, theirs = tmp_path / "ours.flo", tmp_path / "jax.flo"
    flo.write_flo(str(ours), fl)
    jflo.write_flo(str(theirs), fl)
    assert ours.read_bytes() == theirs.read_bytes()
    assert len(ours.read_bytes()) == 12 + 7 * 11 * 2 * 4
    want = fl.astype(np.float32)
    np.testing.assert_array_equal(flo.read_flo(str(theirs)), want)
    np.testing.assert_array_equal(jflo.read_flo(str(ours)), want)


@pytest.mark.parametrize("shape", [(5, 6, 3), (5, 6, 1), (5, 6)])
def test_write_flo_refuses_other_shapes(tmp_path, shape):
    with pytest.raises(ValueError):
        flo.write_flo(str(tmp_path / "x.flo"), np.zeros(shape, np.float32))
