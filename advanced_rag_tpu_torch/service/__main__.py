"""`python -m advanced_rag_tpu_torch.service` — the port's service entry
point (avoids the double-module-execution of
`-m advanced_rag_tpu_torch.service.app`, which runpy re-runs as __main__
after the package import)."""

from .app import main

if __name__ == "__main__":
    main()
