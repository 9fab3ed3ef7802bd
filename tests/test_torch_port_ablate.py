"""The ablation scripts cut phases out of a kernel's source by text
substitution (``ablate_dcn_bwd.py``, ``ablate_fps.py``); each cut must
still match its source exactly once, or the script raises on the card."""
import pytest

from gaussianformer_tpu_torch import ablate_dcn_bwd, ablate_fps
from gaussianformer_tpu_torch.kernels import _lib


@pytest.mark.parametrize("module, source", [(ablate_dcn_bwd, "dcn_bwd.cu"),
                                            (ablate_fps, "fps.cu")])
def test_ablation_cuts_match_their_source(module, source):
    src = (_lib.CSRC_DIR / source).read_text()
    for name, old, new in module.CUTS:
        assert src.count(old) == 1, name
        assert old != new, name
