"""Gradio web UI of the PyTorch port: the JAX package's six tabs
(``vad_tpu/ui/app.py``) over ``vad_tpu_torch/ui/logic.py``.

Tabs: Analyze Images, Analyze Video, Train Image Model, Train Video Model,
View Results, Help.  Training and evaluation run the port's CLIs with live
output; analysis runs the port's models on the ``AppState``'s device.
gradio is imported inside ``create_ui``; ``python -m vad_tpu_torch.ui``
prints the CLI equivalents where it is not installed.
"""

from __future__ import annotations

import numpy as np

from vad_tpu_torch.ui import logic
from vad_tpu_torch.ui.logic import AppState

HELP_MD = """
## Help and Documentation

---

### Image Anomaly Detection

Train on normal images, detect defects as reconstruction failures.

**Folder structure for custom image datasets:**
```
data/your_category/
    train/good/          (normal images)
    test/good/           (normal test images)
    test/defect_type/    (defective images)
```

---

### Video Anomaly Detection

Train on normal video sequences, detect temporal anomalies.

**Folder structure for custom video datasets:**
```
data/your_category/
    train/normal/
        video_001.mp4    (or folder of frames)
    test/normal/
    test/anomaly/
```

**IPAD Dataset:** pre-formatted industrial video data in `data/IPAD/`.

No dataset handy? Generate a synthetic one:
```
python -m vad_tpu_torch.data.synthetic --data-dir ./data --category synthetic
python download_data.py --method synthetic-video --category S01
```

---

### Interpreting Results

- **AUROC**: 0.5 = random, 0.7-0.8 = good, 0.9+ = excellent
- **Separation Ratio**: higher = better anomaly detection
- **Error Heatmap**: red/yellow = high error = potential anomaly

---

### About

Anomaly detection with the PyTorch/CUDA port (vad_tpu_torch).
Image: conv autoencoder. Video: ConvLSTM autoencoder whose recurrence
is a hand-written CUDA kernel, with state-carrying streaming inference.
"""


def create_ui(state: AppState | None = None):
    """The six-tab app over ``state`` (a new CUDA ``AppState`` when None)."""
    import gradio as gr

    state = state or AppState()

    def on_analyze_image(img):
        return logic.analyze_image(state, img)

    def on_analyze_video(path):
        return logic.analyze_video(state, path)

    def on_start_training(category, epochs, batch_size, lr, loss):
        if not category or category.startswith("No datasets"):
            yield "Error: No dataset found."
            return
        data_dir = logic.find_data_dir_for_category(category)
        if data_dir is None:
            yield f"Error: Could not find dataset for '{category}'."
            return
        header = (
            f"TRAINING STARTED\n{'=' * 60}\n\n"
            f"Configuration:\n- Category: {category}\n- Epochs: {int(epochs)}\n"
            f"- Batch Size: {int(batch_size)}\n- Loss: {loss}\n\n{'=' * 60}\n"
        )
        yield from logic.stream_subprocess(
            logic.build_train_command(category, epochs, batch_size, lr, loss, data_dir,
                                      state.device.type),
            header,
        )

    def on_start_video_training(category, epochs, batch_size, lr):
        if not category or category.startswith("No video datasets"):
            yield "Error: No video dataset found."
            return
        data_dir = logic.find_data_dir_for_category(category, video=True)
        if data_dir is None:
            yield f"Error: Could not find video dataset for '{category}'."
            return
        header = (
            f"VIDEO TRAINING STARTED\n{'=' * 60}\n\n"
            f"Configuration:\n- Category: {category}\n- Data Directory: {data_dir}\n"
            f"- Epochs: {int(epochs)}\n- Batch Size: {int(batch_size)}\n"
            f"- Learning Rate: {lr}\n\n"
            f"*** Saving based on SEPARATION RATIO (not loss) ***\n\n{'=' * 60}\n"
        )
        yield from logic.stream_subprocess(
            logic.build_video_train_command(category, epochs, batch_size, lr, data_dir,
                                            state.device.type),
            header,
        )

    def on_run_evaluation(checkpoint_path):
        if not checkpoint_path:
            return "Please select a checkpoint first.", None, None, None, ""
        cmd = logic.build_eval_command(checkpoint_path, state.device.type)
        if cmd is None:
            return "Error: dataset for this checkpoint not found.", None, None, None, ""
        status_lines = []
        for chunk in logic.stream_subprocess(cmd, "Running evaluation...\n\n"):
            status_lines = [chunk]
        roc, dist, recon, summary = logic.load_results_artifacts(checkpoint_path)
        return status_lines[-1] if status_lines else "", roc, dist, recon, summary

    with gr.Blocks(title="Anomaly Detection System") as app:
        gr.Markdown(
            "# Industrial Anomaly Detection System\n"
            "PyTorch/CUDA port — detect manufacturing defects in "
            "**images** and **videos**.\n\n---"
        )
        with gr.Tabs():
            with gr.Tab("Analyze Images"):
                gr.Markdown("## Image Anomaly Detection")
                gr.Markdown("### Step 1: Load a Model")
                with gr.Row():
                    ckpt_dd = gr.Dropdown(
                        choices=logic.discover_checkpoints("image"), label="Select Image Model"
                    )
                    refresh_btn = gr.Button("Refresh", variant="secondary")
                    load_btn = gr.Button("Load Model", variant="primary")
                model_status = gr.Textbox(label="Model Status", lines=6, value="No model loaded.")
                gr.Markdown("### Step 2: Upload and Analyze")
                with gr.Row():
                    input_image = gr.Image(label="Upload Image", type="numpy")
                    recon_out = gr.Image(label="Reconstruction")
                    heat_out = gr.Image(label="Error Heatmap")
                analyze_btn = gr.Button("Analyze Image", variant="primary", size="lg")
                report_box = gr.Textbox(label="Analysis Report", lines=15)

                refresh_btn.click(
                    fn=lambda: gr.Dropdown(choices=logic.discover_checkpoints("image")),
                    outputs=ckpt_dd,
                )
                load_btn.click(fn=state.load_image_model, inputs=ckpt_dd, outputs=model_status)
                analyze_btn.click(
                    fn=on_analyze_image, inputs=input_image,
                    outputs=[recon_out, heat_out, report_box],
                )

            with gr.Tab("Analyze Video"):
                gr.Markdown("## Video Anomaly Detection")
                gr.Markdown("### Step 1: Load a Video Model")
                with gr.Row():
                    v_ckpt_dd = gr.Dropdown(
                        choices=logic.discover_checkpoints("video"), label="Select Video Model"
                    )
                    v_refresh_btn = gr.Button("Refresh", variant="secondary")
                    v_load_btn = gr.Button("Load Model", variant="primary")
                v_status = gr.Textbox(label="Model Status", lines=6, value="No video model loaded.")
                gr.Markdown("### Step 2: Upload and Analyze Video")
                video_input = gr.Video(label="Upload Video")
                v_analyze_btn = gr.Button("Analyze Video", variant="primary", size="lg")
                timeline_out = gr.Image(label="Anomaly Score Timeline")
                v_report = gr.Textbox(label="Analysis Report", lines=15)

                v_refresh_btn.click(
                    fn=lambda: gr.Dropdown(choices=logic.discover_checkpoints("video")),
                    outputs=v_ckpt_dd,
                )
                v_load_btn.click(fn=state.load_video_model, inputs=v_ckpt_dd, outputs=v_status)
                v_analyze_btn.click(
                    fn=on_analyze_video, inputs=video_input, outputs=[timeline_out, v_report]
                )

            with gr.Tab("Train Image Model"):
                gr.Markdown("## Train Image Anomaly Detection Model")
                with gr.Row():
                    with gr.Column():
                        cat_dd = gr.Dropdown(
                            choices=logic.discover_image_categories(), label="Dataset Category"
                        )
                        epochs_s = gr.Slider(10, 200, value=50, step=10, label="Epochs")
                        batch_s = gr.Slider(4, 64, value=16, step=4, label="Batch Size")
                    with gr.Column():
                        lr_dd = gr.Dropdown(
                            choices=[0.0001, 0.0005, 0.001, 0.005], value=0.001,
                            label="Learning Rate",
                        )
                        loss_dd = gr.Dropdown(
                            choices=["mse", "ssim", "combined"], value="mse",
                            label="Loss Function",
                        )
                train_btn = gr.Button("Start Training", variant="primary", size="lg")
                train_out = gr.Textbox(label="Training Status", lines=25)
                train_btn.click(
                    fn=on_start_training,
                    inputs=[cat_dd, epochs_s, batch_s, lr_dd, loss_dd],
                    outputs=train_out,
                )

            with gr.Tab("Train Video Model"):
                gr.Markdown("## Train Video Anomaly Detection Model")
                gr.Markdown(
                    "Trains a ConvLSTM model on video sequences; saves by "
                    "**separation ratio** (not loss) for best anomaly detection."
                )
                with gr.Row():
                    with gr.Column():
                        v_cat_dd = gr.Dropdown(
                            choices=logic.discover_video_categories(), label="Video Dataset"
                        )
                        v_epochs_s = gr.Slider(5, 50, value=10, step=5, label="Epochs")
                    with gr.Column():
                        v_batch_s = gr.Slider(2, 16, value=4, step=2, label="Batch Size")
                        v_lr_dd = gr.Dropdown(
                            choices=[0.0001, 0.0005, 0.001], value=0.0001,
                            label="Learning Rate",
                        )
                v_train_btn = gr.Button("Start Video Training", variant="primary", size="lg")
                v_train_out = gr.Textbox(label="Training Status", lines=25)
                v_train_btn.click(
                    fn=on_start_video_training,
                    inputs=[v_cat_dd, v_epochs_s, v_batch_s, v_lr_dd],
                    outputs=v_train_out,
                )

            with gr.Tab("View Results"):
                gr.Markdown("## Evaluation Results")
                with gr.Row():
                    r_ckpt_dd = gr.Dropdown(
                        choices=logic.discover_checkpoints("all"), label="Select Model"
                    )
                    r_refresh_btn = gr.Button("Refresh", variant="secondary")
                with gr.Row():
                    run_eval_btn = gr.Button("Run Evaluation", variant="primary")
                    view_btn = gr.Button("View Existing Results", variant="secondary")
                eval_status = gr.Textbox(label="Evaluation Status", lines=15)
                results_summary = gr.Textbox(label="Results Summary", lines=8)
                with gr.Row():
                    roc_img = gr.Image(label="ROC Curve")
                    dist_img = gr.Image(label="Score Distribution")
                recon_img = gr.Image(label="Sample Visualizations")

                r_refresh_btn.click(
                    fn=lambda: gr.Dropdown(choices=logic.discover_checkpoints("all")),
                    outputs=r_ckpt_dd,
                )
                run_eval_btn.click(
                    fn=on_run_evaluation,
                    inputs=r_ckpt_dd,
                    outputs=[eval_status, roc_img, dist_img, recon_img, results_summary],
                )
                view_btn.click(
                    fn=logic.load_results_artifacts,
                    inputs=r_ckpt_dd,
                    outputs=[roc_img, dist_img, recon_img, results_summary],
                )

            with gr.Tab("Help"):
                gr.Markdown(HELP_MD)

        gr.Markdown("---\n*Anomaly Detection System | PyTorch/CUDA port, built with Gradio*")
    return app


def launch(host: str = "0.0.0.0", port: int = 7860, device=None) -> None:
    app = create_ui(AppState(device))
    app.launch(server_name=host, server_port=port, share=False)
