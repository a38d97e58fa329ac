"""Run a TUM RGB-D sequence through the full stack of the PyTorch port and
report ATE + map statistics.

    PYTHONPATH=.:$PYTHONPATH python examples_torch/run_tum.py <sequence_dir> \
        [--pose-source slam|groundtruth] [--max-frames N] [--device cuda|cpu]

Without arguments, writes + runs a synthetic TUM-format sequence (no
dataset download needed; exercises the identical code path: PNG decode,
association, odometry, BA, fusion, ATE).
"""
import argparse
import sys
import tempfile


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence", nargs="?", default=None)
    ap.add_argument("--pose-source", default="slam",
                    choices=["slam", "groundtruth"])
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--ba-every", type=int, default=8)
    ap.add_argument("--codec", default="dpcm",
                    choices=["none", "dpcm", "dpcm_temporal"],
                    help="depth-link codec (dpcm_temporal adds P-frames "
                         "against the previous frame — real slow-moving "
                         "camera streams code 1-2 bits narrower)")
    ap.add_argument("--codec-quant-shift", type=int, default=0)
    ap.add_argument("--codec-p4-budget", type=int, default=0,
                    help="enable sparse p4 P-frames (dpcm_temporal "
                         "only): per-row literal byte budget, 0 = "
                         "classic fixed-width P-frames")
    ap.add_argument("--codec-hysteresis", type=int, default=0,
                    help="p4 hysteresis quantization margin (raw depth "
                         "units)")
    ap.add_argument("--loop-close", action="store_true",
                    help="detect loop closures + pose-graph optimize "
                         "after the run (slam/loop_closure.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the odometry, BA, loop closure "
                         "and fusion engine")
    ap.add_argument("--hard", action="store_true",
                    help="render the HARD synthetic benchmark sequence "
                         "(640x480, 150 frames, aggressive orbit with "
                         "loop closure, quadratic depth noise + range-"
                         "growing dropout) instead of the quick one")
    args = ap.parse_args()

    from ros_gpu_depthmap_fusion_tpu_torch.pipeline.tum_runner import (
        run_tum_sequence, write_hard_synthetic_tum_sequence,
        write_synthetic_tum_sequence)

    root = args.sequence
    if root is None:
        root = tempfile.mkdtemp(prefix="tum_synth_")
        if args.hard:
            print(f"writing HARD synthetic TUM sequence to {root} "
                  "(640x480 x 150 frames — takes a minute)")
            write_hard_synthetic_tum_sequence(root)
        else:
            print(f"no sequence given; writing synthetic TUM sequence "
                  f"to {root}")
            write_synthetic_tum_sequence(root, n_frames=20, width=320,
                                         height=240)
            if args.max_frames is None:
                args.max_frames = 20

    res = run_tum_sequence(root, pose_source=args.pose_source,
                           max_frames=args.max_frames,
                           ba_every=args.ba_every, codec=args.codec,
                           codec_quant_shift=args.codec_quant_shift,
                           codec_p4_budget=args.codec_p4_budget,
                           codec_hysteresis=args.codec_hysteresis,
                           loop_close=args.loop_close, device=args.device)
    print(f"frames processed:   {res.frames}")
    print(f"keyframes:          {res.keyframes}")
    print(f"occupied cells:     {res.occupied_cells}")
    print(f"fused points (last frame): {res.fused_points_last}")
    if res.codec_i_frames or res.codec_p_frames:
        print(f"depth link: {res.codec_p_frames} P / "
              f"{res.codec_i_frames} I frames, "
              f"{res.codec_mean_bytes / 1e3:.1f} KB/frame mean")
    if res.loop_edges or res.ate_rmse_loop_closed_m is not None:
        lc = res.ate_rmse_loop_closed_m
        print(f"loop closures:      {res.loop_edges} edges"
              + (f", keyframe ATE {lc*100:.2f} cm" if lc is not None
                 else ""))
    if res.ate_rmse_m is not None:
        print(f"ATE RMSE:           {res.ate_rmse_m*100:.2f} cm")
        if res.ate_rmse_m > 0.05:
            print("WARNING: above the 5 cm target")
            return 1
    else:
        print("ATE: no groundtruth available")
    print("TUM RUN OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
