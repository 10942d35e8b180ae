"""Runtime: session orchestration, native bindings, checkpointing,
metrics, viewers, profiling, the kernel smoke check and stage timing."""
