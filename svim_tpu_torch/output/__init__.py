"""Output layer: BED/VCF writers and report plots.

Byte-compatible with the reference writers (svim/SVIM_CLUSTER.py:29-107,
svim/SVIM_COMBINE.py:18-186).
"""

from svim_tpu_torch.output.writers import (
    sorted_nicely,
    write_candidates,
    write_final_vcf,
    write_signature_clusters_bed,
    write_signature_clusters_vcf,
)

__all__ = [
    "sorted_nicely",
    "write_candidates",
    "write_final_vcf",
    "write_signature_clusters_bed",
    "write_signature_clusters_vcf",
]
