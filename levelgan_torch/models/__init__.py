from levelgan_torch.models.generator import Generator, generator_stages
from levelgan_torch.models.heads import sample_head

__all__ = ["Generator", "generator_stages", "sample_head"]
