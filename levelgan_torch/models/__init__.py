from levelgan_torch.models.critic import Critic
from levelgan_torch.models.generator import Generator, generator_stages
from levelgan_torch.models.heads import sample_head, sample_ids

__all__ = ["Critic", "Generator", "generator_stages", "sample_head",
           "sample_ids"]
