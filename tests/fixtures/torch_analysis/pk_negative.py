"""PK fixture — negatives: every draw names its generator, and the only
seeding is of a torch.Generator object."""
import torch


def sample(logits, generator):
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    pick = torch.multinomial(torch.softmax(logits, -1), 1,
                             generator=generator)
    return u, pick


def init_params(seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.empty(4, 4, device=device)
    w.normal_(0.0, 0.02, generator=gen)
    return w, torch.randperm(4, generator=gen, device=device)


class Sampler:
    def __init__(self, seed):
        self.generator = torch.Generator()
        self.generator.manual_seed(seed)
