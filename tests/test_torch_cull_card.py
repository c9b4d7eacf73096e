"""On the card: the per-ray line cull kernel (ops/csrc/cluster_cull.cu)
against its plain version, bit for bit, on checks.py [13]'s seeded rays.
Skips without a CUDA device. The file imports no JAX, so on a machine
without it run it without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cull_card.py -q
"""

import pytest
import torch

from pathtracer_tpu_torch import checks

pytestmark = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("n_clusters", checks.CULL_CLUSTERS)
def test_cull_kernel_equals_plain(n_clusters):
    """ray_cluster_mask's (B, C) mask from the kernel bit-equal to
    ray_cluster_mask_plain's on 2^20 rays with edge cases against the first
    C seeded boxes; one launch per call; some pairs kept and some culled."""
    card = torch.device("cuda", 0)
    o, d, t_max = checks.cull_rays(checks.CULL_RAYS, card)
    lo, hi = checks.cull_boxes(n_clusters, card)
    got = checks.cull_mismatches(o, d, t_max, lo, hi)
    assert got["differ"] == 0 and got["launches"] == 1, got
    assert 0 < got["kept"] < got["pairs"], got
