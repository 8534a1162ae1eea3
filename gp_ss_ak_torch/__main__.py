import sys

from gp_ss_ak_torch.cli import main

sys.exit(main())
