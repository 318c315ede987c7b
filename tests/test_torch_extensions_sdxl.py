"""PyTorch/CUDA port: FreeU, PAG and DeepCache on the tiny SDXL-layout model
against the JAX package, in fp32 on the CPU: test_torch_extensions.py's
pipeline cases (its PIPELINE_CASES) on the dual-tower UNet with text_time,
the JAX draws injected, within TOL of max(1, max |ref|).
"""

import pytest

from test_torch_extensions import PIPELINE_CASES, PIPELINE_IDS, pipeline_case_matches_jax
from torch_port_helpers import port_test_module, tiny_sdxl_port_model, to_jax_model  # noqa: F401


@pytest.fixture(scope="module")
def sdxl():
    tm = tiny_sdxl_port_model(seed=6)
    return to_jax_model(tm), tm


@pytest.mark.parametrize("kw", PIPELINE_CASES, ids=PIPELINE_IDS)
def test_sdxl_pipeline_extensions_match_jax(sdxl, kw):
    pipeline_case_matches_jax(*sdxl, kw)
