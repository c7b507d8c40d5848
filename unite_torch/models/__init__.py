"""Model families; importing this module registers them."""

from unite_torch.models import (  # noqa: F401
    adaptation,
    clip,
    pretrain_umt,
    pretrain_videomae,
    vit,
)
