"""Dispatch table for the faba subcommand handlers (the port's copy of
the JAX package's `cli/faba_cmds/__init__.py`)."""

from . import (
    annotate_cmds,
    apa_cmds,
    editing_cmds,
    gem_cmds,
    genes_cmds,
    motif_cmds,
    pileup_cmds,
    pipeline_cmds,
    plot_cmds,
    variant_cmds,
)

# parser registration order preserves the original --help listing
PARSER_MODULES = (
    genes_cmds,
    editing_cmds,
    pipeline_cmds,
    motif_cmds,
    pileup_cmds,
    gem_cmds,
    apa_cmds,
    variant_cmds,
    annotate_cmds,
)

HANDLERS = {
    "index": genes_cmds._cmd_index,
    "genes": genes_cmds._cmd_genes,
    "dartseq": editing_cmds._cmd_editing,
    "atoi": editing_cmds._cmd_editing,
    "all": pipeline_cmds._cmd_all,
    "pwm": motif_cmds._cmd_pwm,
    "metagene": motif_cmds._cmd_metagene,
    "pileup": pileup_cmds._cmd_pileup,
    "inspect": pileup_cmds._cmd_pileup,
    "gem": gem_cmds._cmd_gem,
    "gem-encoder": gem_cmds._cmd_gem,
    "lineage": gem_cmds._cmd_lineage,
    "dyn-assoc": gem_cmds._cmd_dyn_assoc,
    "apa": apa_cmds._run_apa_cmd,
    "snp": variant_cmds._cmd_snp,
    "depth": variant_cmds._cmd_depth,
    "annotate": annotate_cmds._cmd_annotate,
    "plot": plot_cmds._run_faba_plot,
}
