"""The hand-written kernels' wrappers (`codec_kernels`, `window_kernels`)."""


def kernel_launches() -> dict:
    """Each kernel's launches in this process so far, counted by its
    wrapper where it launches (a plan graph's replay adds the window
    launches it holds)."""
    from . import codec_kernels, window_kernels

    return dict(codec_kernels.launch_counts(),
                window=window_kernels.window_stat.launches)


def reset_kernel_launches() -> None:
    """Set every kernel's launch count to 0."""
    from . import codec_kernels, window_kernels

    codec_kernels.reset_launch_counts()
    window_kernels.window_stat.launches = 0
