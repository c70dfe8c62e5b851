"""Write an 8 GiB file under build/, fsync and delete it, N times in
turn (``python3 tools/disk_probe.py N`` from the repo root): the
seconds of each write and the disk's use after each delete show
whether freed blocks are reused.
"""
import os
import shutil
import subprocess
import sys
import time

ROOT = "build/disk_probe"


def main(rounds):
    buf = os.urandom(64 << 20)
    print(subprocess.run("df -h . /dev/shm; free -g; nproc", shell=True,
                         capture_output=True, text=True).stdout, flush=True)
    for rnd in range(rounds):
        os.makedirs(ROOT, exist_ok=True)
        t = time.perf_counter()
        with open(f"{ROOT}/f{rnd}", "wb") as f:
            for _ in range(8 * 16):          # 8 GiB
                f.write(buf)
            f.flush()
            os.fsync(f.fileno())
        dt = time.perf_counter() - t
        shutil.rmtree(ROOT)
        os.sync()
        used = shutil.disk_usage(".").used / 2 ** 30
        print(f"round {rnd}: 8 GiB written in {dt:.1f} s, deleted; "
              f"{used:.1f} GiB used", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]))
