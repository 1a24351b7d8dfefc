"""breakmer_tpu — a JAX structural-variant caller for NVIDIA GPUs.

A from-scratch JAX/XLA re-design of the capabilities of
``ccgd-profile/BreaKmer`` (Abo et al., NAR 2015): per target region it
extracts SV-informative reads, subtracts reference k-mers from sample
k-mers, assembles sample-only k-mers into contigs, realigns contigs with a
batched seed-and-extend aligner (a Smith-Waterman CUDA kernel on the
GPU, an XLA wavefront scan elsewhere), and classifies breakpoints into indel / deletion /
tandem-duplication / inversion / translocation calls.

Layer map (mirrors SURVEY.md §7):
  io/        file formats: FASTA, FASTQ, BED, SAM/BAM, config
  encode     base codes, 2-bit packing, padded read batches
  ops/       device kernels: k-mer extract/count/subtract, wavefront SW
  assemble/  greedy k-mer-extension contig assembly (host parity engine)
  align/     seed index + seed-and-extend realignment + host traceback
  call/      breakpoint classification, support counting, filter stack
  parallel/  mesh setup, data-parallel region streaming, call-set merge
  pipeline   per-region driver (reference: sv_processor.py class target)
  runner     orchestrator (reference: sv_processor.py class runner)
  cli        entry point (reference: breakmer.py __main__)
"""

__version__ = "0.1.0"
