"""Serving CLI (counterpart of `repro/launch/serve.py`).

``--vision`` routes to the vision micro-batcher, `vision_serve.main`, with
every other flag (``--model``, ``--no-fuse``, ``--fuse-group-size``,
``--fusion-policy``, ...) passed through; the LM server is not ported yet.

  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model swin_t \
      --full --mode both --no-fuse
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--vision" not in argv:
        raise SystemExit("[serve] only --vision serving is ported yet")
    from repro_torch.launch import vision_serve
    argv.remove("--vision")
    return vision_serve.main(argv)


if __name__ == "__main__":
    main()
