"""Model and embedding-tier modules of the port: `dlrm`, `embedding`,
`interaction`, `placement`, `cache` (the cached tier, sync and async) and
`tiers` (`AsyncCachedTier`)."""
