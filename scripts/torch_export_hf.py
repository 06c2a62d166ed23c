"""Write ``model.safetensors`` beside a Flax-only HF checkpoint.

``advanced_rag_tpu_torch.models.hf_checkpoint`` reads ``model.safetensors``
or ``pytorch_model.bin``, not Flax's ``flax_model.msgpack``, and the card's
machine has neither Flax nor ``transformers``.  This script runs where both
are installed (as ``scripts/torch_convert_checkpoints.py`` does for the
orbax checkpoints): it loads the Flax weights with transformers' Flax class,
copies them into the matching PyTorch class and writes its state dict as
``model.safetensors`` in the same directory, leaving every other file as it
was.  A config whose ``architectures`` name a sequence-classification head
loads as ``AutoModelForSequenceClassification``, any other as ``AutoModel``,
so every encoder family the port reads converts (``bert``, ``roberta``,
``xlm-roberta``, ``electra``, ``distilbert``, ``roberta-prelayernorm``,
``albert``, ``big_bird``, ``roformer``), and so do the GPT families
(``gpt2``, ``gpt-sw3``, ``gpt_neo``, ``gptj``, ``bloom``, ``xglm``:
``tests/test_torch_hf_gpt.py``).

    python scripts/torch_export_hf.py <checkpoint dir> [<dir> ...]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def export(path) -> Path:
    """Convert one Flax-only directory; returns the file written."""
    from safetensors.torch import save_file
    from transformers import (AutoConfig, AutoModel,
                              AutoModelForSequenceClassification, FlaxAutoModel,
                              FlaxAutoModelForSequenceClassification)
    from transformers.modeling_flax_pytorch_utils import (
        load_flax_weights_in_pytorch_model)

    path = Path(path)
    if not (path / "flax_model.msgpack").exists():
        raise FileNotFoundError(f"{path} has no flax_model.msgpack")
    cfg = AutoConfig.from_pretrained(path, local_files_only=True)
    head = any("SequenceClassification" in a for a in cfg.architectures or [])
    flax_cls, pt_cls = ((FlaxAutoModelForSequenceClassification,
                         AutoModelForSequenceClassification) if head
                        else (FlaxAutoModel, AutoModel))
    flax_model = flax_cls.from_pretrained(path, local_files_only=True)
    # from_pretrained(from_flax=True) leaves meta tensors in this
    # transformers (4.57): build the module, then copy the Flax weights in
    model = load_flax_weights_in_pytorch_model(pt_cls.from_config(cfg),
                                               flax_model.params)
    out = path / "model.safetensors"
    save_file({k: v.detach().contiguous() for k, v in model.state_dict().items()},
              str(out), metadata={"format": "pt"})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", help="HF checkpoint directories")
    for d in ap.parse_args().dirs:
        print(export(d))


if __name__ == "__main__":
    main()
