"""Entry point: python -m svim_tpu_torch alignment <wd> <bam> <genome.fa>"""

import sys

from svim_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
