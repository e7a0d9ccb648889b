"""Cross-pod delta sync: the paper's selective flush at the framework
layer (`hier_sync`), its int8 compression with error feedback
(`compress`) and the banks the delta-sync bench and the cross-pod example
drive through it (`delta_sync`)."""
