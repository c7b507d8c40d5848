"""The native FFmpeg video and JPEG decoder, built from ``videodec.cpp`` at
its first use (``_build``)."""
