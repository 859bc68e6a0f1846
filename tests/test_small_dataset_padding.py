"""Regression: datasets smaller than one global batch must still fill the
mesh via tiled wrap-around padding (single-scan deployment with nchips>1,
tiny validation sets)."""
import numpy as np

from bodyct_dram_emph_subtype.inference import run_inference
from bodyct_dram_emph_subtype.train import SubtypeTrainer, TrainerConfig
from tests.test_data import make_training_archive
from tests.test_processor import _write_case


def test_single_scan_fills_multi_chip_batch(tmp_path):
    scan_dir = tmp_path / "ct"
    lobe_dir = tmp_path / "lobes"
    out_dir = tmp_path / "out"
    scan_dir.mkdir(); lobe_dir.mkdir(); out_dir.mkdir()
    _write_case(scan_dir, lobe_dir, "only", shape=(40, 56, 72))
    # global batch = 2 chips x batch 2 = 4 > 1 scan
    results = run_inference(str(scan_dir), str(lobe_dir), str(out_dir),
                            model_arch="med3ddramtiny", ckp_path=None,
                            target_size=(32, 48, 64), batch_size=2,
                            workers=1, nchips=2)
    assert len(results) == 1 and results[0]["entity"] == "only"


def test_eval_set_smaller_than_global_batch(tmp_path):
    make_training_archive(tmp_path, n=3)
    csv = str(tmp_path / "merged.csv")
    cfg = TrainerConfig(model_arch="med3ddramtiny", batch_size=2, nchips=4,
                        target_size=(16, 24, 32), workers=1,
                        data_path=str(tmp_path), train_csv=csv,
                        valid_csv=csv, test_csv=csv,
                        model_path=str(tmp_path / "m"), sampler_seed=0,
                        debug_draw_batches=0)
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    metrics = trainer.evaluate("test", epoch=0)  # 3 samples, batch 8
    assert 0.0 <= metrics["epoch_test_acc_cle"] <= 1.0
    # dedup kept exactly the 3 unique samples
    csv_file = list((cfg.exp_path / "predicts" / "test").glob("*.csv"))[0]
    assert len(csv_file.read_text().strip().splitlines()) == 4  # header + 3
