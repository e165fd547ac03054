"""CLI runner: tool registry + dispatch (src/Runner.java, itmo:Runner.java).

Default tool is environment-finder (src/Runner.java:14-18). The reference
generates its TOOLS registry by a build-time classpath scan (ToolsScanner);
here the registry is an explicit import table.
"""
from __future__ import annotations

import sys

from . import __version__
from .tool import Tool


_TOOL_MODULES = {
    "environment-finder": ("environment_finder", "EnvironmentFinderMain"),
    "kmer-counter": ("kmer_counter", "KmersCounter"),
    "environment-finder-multi": ("environment_finder_multi",
                                 "EnvironmentFinderMultiMain"),
    "reads-classifier": ("reads_classifier", "ReadsClassifier"),
    "triple-reads-classifier": ("triple_reads_classifier",
                                "TripleReadsClassifier"),
    "seq-cov": ("seq_cov", "SequenceCoverage"),
    "environment-assembler-finder": ("environment_assembler_finder",
                                     "EnvironmentAssemblerFinder"),
    "fmt-visualiser": ("fmt_visualiser", "FMTVisualiser"),
    "fmt-visualizer": ("fmt_visualizer", "FMTVisualizer"),
    "recipient-visualiser": ("recipient_visualiser", "RecipientVisualiser"),
    "hic-pipeline": ("hic_pipeline", "HiCPipeline"),
}


def _registry() -> dict[str, type[Tool]]:
    import importlib
    reg: dict[str, type[Tool]] = {}
    for name, (mod, cls) in _TOOL_MODULES.items():
        try:
            m = importlib.import_module(f".tools.{mod}", __package__)
        except ImportError:
            continue
        reg[name] = getattr(m, cls)
    return reg


DEFAULT_TOOL = "environment-finder"

_HEADER = """metacherchant-tpu: JAX genomic environment engine
Usage: metacherchant [-t <tool>] [tool options]
"""


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    reg = _registry()
    tool_name = DEFAULT_TOOL
    explicit_tool = False
    if argv and argv[0] in ("-t", "--tool"):
        if len(argv) < 2:
            print("Option --tool requires a value", file=sys.stderr)
            return 1
        tool_name = argv[1]
        explicit_tool = True
        argv = argv[2:]
    if explicit_tool and tool_name not in reg:
        print(f"Unknown tool {tool_name!r}; use --tools to list", file=sys.stderr)
        return 1
    if argv and argv[0] in ("-ts", "--tools"):
        print("Available tools:")
        for name, cls in sorted(reg.items()):
            print(f"  {name:32s} {cls.DESCRIPTION}")
        return 0
    if argv and argv[0] in ("--version",):
        print(f"metacherchant-tpu {__version__}")
        return 0
    if (argv and argv[0] in ("-h", "--help")) or (not argv and not explicit_tool):
        print(_HEADER)
        print("Tools (select with -t):")
        for name, cls in sorted(reg.items()):
            print(f"  {name:32s} {cls.DESCRIPTION}")
        return 0
    if tool_name not in reg:
        print(f"Unknown tool {tool_name!r}; use --tools to list", file=sys.stderr)
        return 1
    tool = reg[tool_name]()
    return tool.main(argv)


if __name__ == "__main__":
    sys.exit(main())
