"""Dependency-free HTML documentation builder.

The reference renders ex_doc with function grouping by the @doc type:
taxonomy (/root/reference/mix.exs:36-55 — groups_for_docs over
Windowing/Time-frequency/Filters/Waveforms/Peak finding, KaTeX extras).
Sphinx/pdoc are not installed in this image, so this builder renders the
same artifact directly from the in-repo sources of truth:

* the registry taxonomy (nx_signal_tpu/registry.py) -> grouped API pages
  with live signatures + docstrings via inspect,
* the executable guides (guides/*.md, run by tests/test_guides.py) ->
  rendered HTML pages.

Usage:  python scripts/build_docs.py [outdir]     (default docs/html)
Exits nonzero on any warning (missing docstring, unimportable function) —
the ex_doc-style "docs build must be clean" gate, wired into CI.
"""

import html
import importlib
import inspect
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax

jax.config.update("jax_platforms", "cpu")

from nx_signal_tpu.registry import FUNCTION_TYPES, TAXONOMY  # noqa: E402

GROUP_TITLES = {
    "time_frequency": "Time-frequency (STFT engine)",
    "windowing": "Windowing",
    "filters": "Filters & filter design",
    "waveforms": "Waveforms",
    "peak_finding": "Peak finding",
    "convolution": "Convolution",
    "transforms": "Transforms",
    "special": "Special functions & checks",
    "resampling": "Resampling & rate conversion",
    "parallel": "Parallel / sharded (multi-chip)",
    "streaming": "Streaming (stateful)",
    "io": "IO & checkpointing",
}

CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif; margin: 0;
       display: flex; color: #1a1a1a; }
nav { width: 260px; min-height: 100vh; background: #f4f4f6; padding: 1rem;
      box-sizing: border-box; flex-shrink: 0; }
nav a { display: block; color: #444; text-decoration: none; padding: 2px 0; }
nav a:hover { color: #000; }
nav h2 { font-size: 0.85rem; text-transform: uppercase; color: #888; }
main { padding: 2rem 3rem; max-width: 54rem; }
h1 { border-bottom: 2px solid #e6e6e6; padding-bottom: 0.3rem; }
h2.group { margin-top: 2.5rem; border-bottom: 1px solid #eee; }
article { margin: 1.2rem 0; }
article h3 { font-family: ui-monospace, Menlo, monospace; font-size: 1rem;
             background: #f4f4f6; padding: 0.4rem 0.6rem; border-radius: 6px; }
article .mod { color: #888; font-weight: normal; }
pre, code { font-family: ui-monospace, Menlo, monospace; font-size: 0.85rem; }
pre { background: #f8f8fa; border: 1px solid #ececf0; border-radius: 6px;
      padding: 0.8rem; overflow-x: auto; white-space: pre-wrap; }
.doc { white-space: pre-wrap; margin: 0.4rem 0 0 0.6rem; color: #333; }
"""


def _md_to_html(text):
    """Minimal markdown renderer for the guides: headers, fenced code,
    inline code, bold, paragraphs."""
    out, in_code = [], False
    for line in text.split("\n"):
        if line.startswith("```"):
            out.append("</code></pre>" if in_code else "<pre><code>")
            in_code = not in_code
            continue
        if in_code:
            out.append(html.escape(line))
            continue
        m = re.match(r"^(#{1,4})\s+(.*)$", line)
        if m:
            n = len(m.group(1))
            out.append(f"<h{n}>{html.escape(m.group(2))}</h{n}>")
            continue
        esc = html.escape(line)
        esc = re.sub(r"`([^`]+)`", r"<code>\1</code>", esc)
        esc = re.sub(r"\*\*([^*]+)\*\*", r"<strong>\1</strong>", esc)
        out.append(esc + ("<br>" if esc.strip() else "<p>"))
    return "\n".join(out)


def _page(title, nav, body):
    return (
        f"<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title><style>{CSS}</style></head>"
        f"<body><nav>{nav}</nav><main>{body}</main></body></html>"
    )


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs", "html")
    os.makedirs(outdir, exist_ok=True)
    warnings = []

    # Collect: category -> [(qualname, signature, doc)]
    groups = {cat: [] for cat in TAXONOMY}
    for mod_path, funcs in sorted(FUNCTION_TYPES.items()):
        module = importlib.import_module(f"nx_signal_tpu.{mod_path}")
        for name, cat in sorted(funcs.items()):
            obj = getattr(module, name, None)
            if obj is None:
                warnings.append(f"{mod_path}.{name}: not found in module")
                continue
            try:
                sig = str(inspect.signature(obj))
            except (TypeError, ValueError):
                sig = "(...)"
            doc = inspect.getdoc(obj)
            if not doc:
                warnings.append(f"{mod_path}.{name}: missing docstring")
                doc = ""
            groups[cat].append((mod_path, name, sig, doc))

    guides = sorted(
        f for f in os.listdir("guides") if f.endswith(".md")
    ) if os.path.isdir("guides") else []

    nav_parts = ["<h2>API groups</h2>"]
    for cat in sorted(groups, key=lambda c: GROUP_TITLES.get(c, c)):
        if groups[cat]:
            nav_parts.append(
                f"<a href='index.html#{cat}'>{GROUP_TITLES.get(cat, cat)}"
                f" ({len(groups[cat])})</a>")
    nav_parts.append("<h2>Guides</h2>")
    for g in guides:
        stem = g[:-3]
        nav_parts.append(f"<a href='guide_{stem}.html'>{stem}</a>")
    nav = "\n".join(nav_parts)

    # API index page
    body = ["<h1>nx_signal_tpu API</h1>",
            "<p>DSP framework on JAX/XLA mirroring elixir-nx/nx_signal's "
            "surface. Functions are grouped by the registry taxonomy "
            "(the reference's <code>@doc type:</code> groups).</p>"]
    n_funcs = 0
    for cat in sorted(groups, key=lambda c: GROUP_TITLES.get(c, c)):
        entries = groups[cat]
        if not entries:
            continue
        body.append(f"<h2 class='group' id='{cat}'>"
                    f"{GROUP_TITLES.get(cat, cat)}</h2>")
        for mod_path, name, sig, doc in entries:
            n_funcs += 1
            body.append(
                "<article>"
                f"<h3><span class='mod'>nx_signal_tpu.{mod_path}.</span>"
                f"{html.escape(name)}<span class='mod'>"
                f"{html.escape(sig)}</span></h3>"
                f"<div class='doc'>{html.escape(doc)}</div></article>")
    with open(os.path.join(outdir, "index.html"), "w") as f:
        f.write(_page("nx_signal_tpu API", nav, "\n".join(body)))

    for g in guides:
        stem = g[:-3]
        with open(os.path.join("guides", g)) as fh:
            content = _md_to_html(fh.read())
        with open(os.path.join(outdir, f"guide_{stem}.html"), "w") as f:
            f.write(_page(f"Guide: {stem}", nav, content))

    print(f"built {outdir}: {n_funcs} functions, {len(guides)} guides")
    if warnings:
        print(f"{len(warnings)} warnings:", file=sys.stderr)
        for w in warnings:
            print(f"  - {w}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
