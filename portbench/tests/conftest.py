"""Keep each test process to two threads: the tiny runs are small, and
several test workers share the machine's cores."""
import torch

torch.set_num_threads(2)
