"""Command line of the port, with the JAX package's commands and options
(its ``cli.py``) and ``--device`` (``cuda`` unless ``cpu`` is asked for):

    python -m comic_text_detector_tpu_torch.cli annotate  --model X.pt --img-dir D --save-dir O
    python -m comic_text_detector_tpu_torch.cli detect    --model X.pt --image page.png --out-prefix o
    python -m comic_text_detector_tpu_torch.cli train-seg --hyp hyp.yaml [--set train.lr0=0.004 ...]
    python -m comic_text_detector_tpu_torch.cli train-db  --hyp hyp.yaml
    python -m comic_text_detector_tpu_torch.cli render    --bg-dir D --save-dir O [--n 100]
    python -m comic_text_detector_tpu_torch.cli export    --model X.pt --out model.pt2

``detect`` and ``annotate`` take ``--trace PATH``: the port's stages are
recorded as spans (``utils/profiling.py``) and written to ``PATH`` as
Chrome JSON, on the clock of a ``torch.profiler`` trace, for Perfetto.

``export`` writes the ``torch.export`` program (``export/program.py``; the
JAX package writes ``.stablehlo``) and runs its parity check.  ``render``
needs Pillow and the system fonts, and ``--hyp`` / ``--set`` need ``yaml``;
neither is among the packages the card's machine is stated to have.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Dict, List


def _parse_sets(pairs: List[str]) -> Dict:
    """``--set a.b.c=value`` (the value read as YAML) into a nested override
    dict."""
    out: Dict = {}
    for pair in pairs or []:
        import yaml

        key, _, val = pair.partition("=")
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(val)
    return out


@contextlib.contextmanager
def _spans(path):
    """Record the port's spans over the block and write them to ``path``
    (nothing without one)."""
    if not path:
        yield
        return
    from comic_text_detector_tpu_torch.utils import profiling

    profiling.enable()
    try:
        yield
    finally:
        got = profiling.disable()
        got.write_chrome(path)
        print(f"{len(got.spans)} spans -> {path}")


def cmd_annotate(args):
    from comic_text_detector_tpu_torch.pipeline import model2annotations

    with _spans(args.trace):
        model2annotations(args.model, args.img_dir, args.save_dir, save_json=args.save_json,
                          input_size=args.input_size, device=args.device)


def cmd_detect(args):
    from comic_text_detector_tpu_torch.pipeline import TextDetector
    from comic_text_detector_tpu_torch.utils.io import NumpyEncoder, imread, imwrite

    det = TextDetector(args.model, input_size=args.input_size, device=args.device)
    img = imread(args.image)
    with _spans(args.trace):
        mask, mask_refined, blk_list = det(img, keep_undetected_mask=True)
    imwrite(args.out_prefix + "-mask.png", mask)
    imwrite(args.out_prefix + "-mask-refined.png", mask_refined)
    with open(args.out_prefix + "-blocks.json", "w", encoding="utf8") as f:
        json.dump([b.to_dict() for b in blk_list], f, ensure_ascii=False, cls=NumpyEncoder)
    print(f"{len(blk_list)} blocks -> {args.out_prefix}-*")


def cmd_train_seg(args):
    from comic_text_detector_tpu_torch.training import seg_trainer
    from comic_text_detector_tpu_torch.utils.config import dump_effective, load_hyp

    hyp = load_hyp(args.hyp, kind="seg", overrides=_parse_sets(args.set))
    dump_effective(hyp, hyp["data"].get("save_dir", "data") + "/training_hyp.yaml")
    seg_trainer.train(hyp, max_steps=args.max_steps, device=args.device)


def cmd_train_db(args):
    from comic_text_detector_tpu_torch.training import db_trainer
    from comic_text_detector_tpu_torch.utils.config import dump_effective, load_hyp

    hyp = load_hyp(args.hyp, kind="db", overrides=_parse_sets(args.set))
    dump_effective(hyp, hyp["data"].get("save_dir", "data") + "/training_db_hyp.yaml")
    db_trainer.train(hyp, max_steps=args.max_steps, device=args.device)


def cmd_render(args):
    from comic_text_detector_tpu_torch.data.render import render_comictext

    n = render_comictext(args.bg_dir, args.save_dir, n_pages=args.n, seed=args.seed)
    print(f"rendered {n} pages -> {args.save_dir}")


def cmd_export(args):
    from comic_text_detector_tpu_torch.export import export_program, parity_check
    from comic_text_detector_tpu_torch.weights import load_model_file

    weights, cfg = load_model_file(args.model)
    export_program(weights, args.out, input_size=args.input_size, cfg=cfg, device=args.device)
    ok, diff = parity_check(weights, args.out, input_size=args.input_size, cfg=cfg, device=args.device)
    print(f"exported -> {args.out}; parity ok={ok} max_diff={diff:.2e}")
    if not ok:
        raise SystemExit(f"{args.out}: the program's outputs lie {diff:.2e} from the module's")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="comic_text_detector_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("annotate", help="batch-annotate image dirs (label factory)")
    a.add_argument("--model", required=True)
    a.add_argument("--img-dir", required=True, nargs="+")
    a.add_argument("--save-dir", required=True)
    a.add_argument("--save-json", action="store_true")
    a.add_argument("--input-size", type=int, default=1024)
    a.set_defaults(fn=cmd_annotate)

    d = sub.add_parser("detect", help="detect text on one page")
    d.add_argument("--model", required=True)
    d.add_argument("--image", required=True)
    d.add_argument("--out-prefix", default="out")
    d.add_argument("--input-size", type=int, default=1024)
    d.set_defaults(fn=cmd_detect)

    for name, fn in (("train-seg", cmd_train_seg), ("train-db", cmd_train_db)):
        t = sub.add_parser(name)
        t.add_argument("--hyp", default=None)
        t.add_argument("--set", nargs="*", help="dotted overrides, e.g. train.lr0=0.004")
        t.add_argument("--max-steps", type=int, default=None)
        t.set_defaults(fn=fn)

    r = sub.add_parser("render", help="render synthetic training pages (needs Pillow)")
    r.add_argument("--bg-dir", required=True)
    r.add_argument("--save-dir", required=True)
    r.add_argument("--n", type=int, default=None)
    r.add_argument("--seed", type=int, default=0)
    r.set_defaults(fn=cmd_render)

    e = sub.add_parser("export", help="export the torch.export deploy program (.pt2)")
    e.add_argument("--model", required=True)
    e.add_argument("--out", required=True)
    e.add_argument("--input-size", type=int, default=1024)
    e.set_defaults(fn=cmd_export)

    for s in (a, d, e, *(sub.choices[n] for n in ("train-seg", "train-db"))):
        s.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    for s in (a, d):
        s.add_argument("--trace", default=None, metavar="PATH",
                       help="write the port's stages as spans to PATH (Chrome JSON, for Perfetto)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
