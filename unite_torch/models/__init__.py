"""Model families; importing this module registers them."""

from unite_torch.models import adaptation, clip, vit  # noqa: F401
