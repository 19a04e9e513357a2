"""Model and embedding-tier modules of the port: `dlrm`, `embedding`,
`interaction`, `placement`, `design_space` (the paper's section-V
suite), `cache` (the cached tier, sync and async),
`tiers` (the `EmbeddingTier` protocol, `AsyncCachedTier` and the
three-tier bulk collection) and `hostmem` (page-locked host memory for a
capacity tier the card reads over PCIe)."""
