"""``python -m cmad_tpu_torch <command> deck.yaml [--device cpu]``."""
from cmad_tpu_torch.cli.main import console_main

if __name__ == "__main__":
    console_main()
