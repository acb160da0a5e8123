"""`version` subcommand (reference turing/main.cpp:54-162 `turing version`
/ turing.h turing_version): print the framework version and backend info.
"""
import sys


def main():
    import turingcodec
    print(f"turingcodec {turingcodec.__version__}")
    try:
        import jax
        devs = jax.devices()
        print(f"jax {jax.__version__}  devices: "
              + ", ".join(str(d) for d in devs))
    except Exception as e:  # no backend available
        print(f"jax unavailable: {e}")
    from turingcodec.native import get_lib
    lib = get_lib()
    print("native core:", "loaded" if lib is not None else "unavailable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
