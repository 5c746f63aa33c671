"""The LM scaffold, ported: dense transformer and RWKV6 (serving paths)."""
