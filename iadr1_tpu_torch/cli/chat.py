"""Interactive chat CLI (llamafactory-cli chat equivalent; the port's
counterpart of iadr1_tpu/cli/chat.py).  Runs on the card unless given
``--device cpu``.

Usage:
    python -m iadr1_tpu_torch.cli.chat --model-path <ckpt> [--device cpu]

Commands inside the loop: "/image <path>" attaches an image to the next
message, "/clear" resets history, "/exit" quits.
"""

from __future__ import annotations

import argparse
from typing import Callable


def chat_loop(gen, read: Callable[[str], str] | None = None,
              write: Callable[[str], None] | None = None) -> int:
    """The read-generate-print loop over a ``VLMGenerator``: ``read(prompt)``
    returns the next line (default ``input``; EOFError or
    KeyboardInterrupt ends the loop), ``write`` prints (default
    ``print``).  Every turn sends the whole history, with every image
    attached so far."""
    read = read or input
    write = write or print
    history: list[dict] = []
    images: list = []
    pending_image = None
    write("chat ready. /image <path> to attach, /clear to reset, /exit to quit.")
    while True:
        try:
            line = read("user> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            continue
        if line == "/exit":
            break
        if line == "/clear":
            history, images, pending_image = [], [], None
            write("(history cleared)")
            continue
        if line.startswith("/image "):
            pending_image = line.split(" ", 1)[1].strip()
            write(f"(image attached: {pending_image})")
            continue
        content = line
        if pending_image:
            content = "<image>" + content
            images.append(pending_image)
            pending_image = None
        history.append({"role": "user", "content": content})
        reply = gen.generate([{"messages": history, "images": images}])[0]
        history.append({"role": "assistant", "content": reply})
        write(f"assistant> {reply}")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--template", default=None)
    parser.add_argument("--max-prompt-length", type=int, default=2048)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--temperature", type=float, default=0.7)
    parser.add_argument("--patch-budget", type=int, default=4096)
    parser.add_argument("--attention", default="auto")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' runs the plain "
                        "PyTorch path")
    args = parser.parse_args(argv)

    import torch
    from transformers import AutoTokenizer

    from iadr1_tpu_torch.core.device import resolve_device
    from iadr1_tpu_torch.data.template import get_template
    from iadr1_tpu_torch.eval.generator import GeneratorConfig, VLMGenerator
    from iadr1_tpu_torch.models.params_io import load_safetensors_path
    from iadr1_tpu_torch.models.registry import bundle_from_pretrained

    device = resolve_device(args.device)
    bundle = bundle_from_pretrained(args.model_path, attention=args.attention)
    params = bundle.convert_hf(load_safetensors_path(args.model_path),
                               dtype=torch.bfloat16, device=device)
    tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    template = get_template(args.template or bundle.template)
    gen = VLMGenerator(
        bundle, params, tokenizer, template,
        GeneratorConfig(
            max_prompt_length=args.max_prompt_length,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature, batch_size=1,
            patch_budget=args.patch_budget,
        ),
        device=device,
    )
    return chat_loop(gen)


if __name__ == "__main__":
    raise SystemExit(main())
