"""Scale-out of the port: --distributed (ranks over torch.distributed,
multihost.py and cluster_shard.py) and --num_shards (the batched ops'
leading axis cut over the visible devices, mesh.py)."""
