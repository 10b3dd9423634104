"""``python -m msla_tpu_torch <overrides>``: the port's command line (``main.py``)."""
from msla_tpu_torch.main import main

if __name__ == "__main__":
    main()
