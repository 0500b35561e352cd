"""PK fixture — true positives. Parsed by the analyzer, never imported:
draws off the process-global stream (PK501) and global reseeding in
library code (PK502)."""
import torch


def sample(logits, temperature):
    u = torch.rand(logits.shape, device=logits.device)      # PK501
    probs = torch.softmax(logits / temperature, -1)
    pick = torch.multinomial(probs, 1)                      # PK501
    return u, pick


def init_weights(w, gen=None):
    torch.nn.init.normal_(w, std=0.02)                      # PK501
    w.uniform_(-1, 1)                                       # PK501
    return torch.randn(4, 4, generator=None)                # PK501 (None)


def reset(seed):
    torch.manual_seed(seed)                                 # PK502
    torch.cuda.manual_seed_all(seed)                        # PK502
